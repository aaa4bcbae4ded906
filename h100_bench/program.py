"""The system under test: the PyTorch port's model, train step and eval
step, built from a configuration file's shipped YAML through the port's own
config reader, and loaded with the benchmark's weights.

Everything of the port is imported inside these functions, so that the
harness's modules import without it (a checkout that holds only the
benchmark fails in `build`, not at import)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from h100_bench import spec


def cfg_of(conf: Dict, mode: str):
    from combo_avs_torch.config import setup_cfg

    yaml = conf["yaml"][mode]
    return setup_cfg(f"{spec.ROOT}/{yaml}", list(conf.get("opts", [])) + ["MODEL.DEVICE",
                                                                          conf["device"]])


def check_cfg(cfg, conf: Dict, mode: str) -> None:
    """The numbers the reference takes from the configuration file must be
    the ones the port reads from the YAML."""
    m, c = conf["model"], conf["criterion"]
    mf = cfg.MODEL.MASK_FORMER
    pairs = {"NUM_CLASSES": (cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, m["num_classes"]),
             "NUM_OBJECT_QUERIES": (mf.NUM_OBJECT_QUERIES, m["num_queries"]),
             "DEC_LAYERS": (mf.DEC_LAYERS, m["dec_layers"]),
             "TRANSFORMER_ENC_LAYERS": (cfg.MODEL.SEM_SEG_HEAD.TRANSFORMER_ENC_LAYERS,
                                        m["enc_layers"]),
             "HIDDEN_DIM": (mf.HIDDEN_DIM, m["hidden_dim"]),
             "TRAIN_NUM_POINTS": (mf.TRAIN_NUM_POINTS, c["num_points"]),
             "OVERSAMPLE_RATIO": (mf.OVERSAMPLE_RATIO, c["oversample_ratio"]),
             "IMPORTANCE_SAMPLE_RATIO": (mf.IMPORTANCE_SAMPLE_RATIO,
                                         c["importance_sample_ratio"]),
             "NO_OBJECT_WEIGHT": (mf.NO_OBJECT_WEIGHT, c["no_object_weight"]),
             "CLASS_WEIGHT": (mf.CLASS_WEIGHT, c["class_weight"]),
             "MASK_WEIGHT": (mf.MASK_WEIGHT, c["mask_weight"]),
             "DICE_WEIGHT": (mf.DICE_WEIGHT, c["dice_weight"]),
             "COSINE_WEIGHT": (mf.COSINE_WEIGHT, c["cosine_weight"]),
             "EXACT_TOPK_POINTS": (bool(mf.get("EXACT_TOPK_POINTS", False)), c["exact_topk"])}
    if mode == "train":
        o, s = conf["optimizer"], cfg.SOLVER
        pairs.update({"AMP": (bool(s.AMP.ENABLED), conf["precision"]["train"]["amp"]),
                      "BASE_LR": (s.BASE_LR, o["base_lr"]), "MAX_ITER": (s.MAX_ITER, o["max_iter"]),
                      "WEIGHT_DECAY": (s.WEIGHT_DECAY, o["weight_decay"]),
                      "BACKBONE_MULTIPLIER": (s.BACKBONE_MULTIPLIER, o["backbone_multiplier"]),
                      "CLIP_VALUE": (s.CLIP_GRADIENTS.CLIP_VALUE, o["clip_value"]),
                      "WARMUP_ITERS": (s.WARMUP_ITERS, 0)})
    wrong = {k: v for k, v in pairs.items() if v[0] != v[1]}
    if wrong:
        raise ValueError(f"the YAML and the configuration file disagree: {wrong}")


def build(conf: Dict, mode: str, device) -> torch.nn.Module:
    from combo_avs_torch.models.meta_arch import build_model

    cfg = cfg_of(conf, mode)
    check_cfg(cfg, conf, mode)
    return build_model(cfg, device=device), cfg


class InjectedDraws:
    """The port's criterion with the benchmark's draws for the steps that
    the reference follows; with none set, the criterion draws from the
    step's own generator, as in training."""

    def __init__(self, criterion):
        self.criterion = criterion
        self.draws = None

    def __call__(self, outputs, targets, frame_weight=None, generator=None, draws=None,
                 world=None):
        return self.criterion(outputs, targets, frame_weight=frame_weight, generator=generator,
                              draws=self.draws, world=world)


def train_step(model, cfg, seed: int, amp: bool = False):
    """(step(batch) -> losses, optimizer, injected draws) of
    `make_train_step` as `train_net` builds it from the config."""
    from combo_avs_torch.losses.criterion import build_criterion, build_weight_dict
    from combo_avs_torch.train.optim import build_optimizer
    from combo_avs_torch.train.train_step import make_train_step

    dev = next(model.parameters()).device
    crit = InjectedDraws(build_criterion(cfg))
    opt = build_optimizer(cfg, model)
    step = make_train_step(model, crit, build_weight_dict(cfg), opt,
                           torch.Generator(device=dev).manual_seed(spec.part_seed(seed,
                                                                                 "criterion")),
                           amp=amp,
                           dropout_generator=torch.Generator(device=dev).manual_seed(
                               spec.part_seed(seed, "dropout")))
    return step, opt, crit


def eval_step(model, out_size, bf16: bool) -> Callable:
    from combo_avs_torch.train.train_step import make_eval_step

    return make_eval_step(model, out_size=tuple(out_size), bf16=bf16)


def first_moments(model, opt) -> Dict[str, torch.Tensor]:
    """Each trained parameter's first gradient as AdamW received it, from its
    state after one step: exp_avg / (1 - beta1)."""
    inner = opt.inner
    out = {}
    for name, p in model.named_parameters():
        st = inner.state.get(p)
        if st is None or "exp_avg" not in st:
            continue
        beta1 = next(g["betas"][0] for g in inner.param_groups if any(q is p for q in g["params"]))
        out[name] = st["exp_avg"] / (1.0 - beta1)
    return out
