"""The port's S4 evaluation entry point against the JAX package on the CPU:
the PNG codec (against cv2 and the native decoder), postprocessing, metrics
and the evaluator, the catalog and the eval mapper, the metric pool, the
reference checkpoint loader, and the slice: the port's `evaluate` and the
JAX package's, on the same weights and the same synthetic videos."""

import os
import pickle
import time

import cv2
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from combo_avs_tpu import native
from combo_avs_tpu.config import get_cfg
from combo_avs_tpu.data import catalogs as jcatalogs
from combo_avs_tpu.data.mappers import AVSSemanticDatasetMapper as JaxMapper
from combo_avs_tpu.evaluation import evaluator as jevaluator
from combo_avs_tpu.evaluation import metrics as jmetrics
from combo_avs_tpu.evaluation import postprocess as jpost
from combo_avs_tpu.train.checkpoint import convert_combo_checkpoint, load_torch_file
from combo_avs_tpu.train.train_step import make_eval_step as jax_make_eval_step
from combo_avs_tpu.train.trainer import evaluate as jax_evaluate
from combo_avs_torch.data import catalogs, png
from combo_avs_torch.data.loader import eval_loader
from combo_avs_torch.data.mappers import AVSSemanticDatasetMapper
from combo_avs_torch.data.synth import make_s4
from combo_avs_torch.evaluation import evaluator, metrics, postprocess
from combo_avs_torch.models.layers import init_weights
from combo_avs_torch.models.meta_arch import MaskFormer
from combo_avs_torch.ops import seminf_cuda
from combo_avs_torch.train import checkpoint
from combo_avs_torch.train.evaluate import MetricPool, evaluate, print_csv_format, verify_results
from combo_avs_torch.train.train_step import make_eval_step
from tests.test_torch_slice import _batch, _port_kwargs, one_torch_thread, release_worker_memory  # noqa: F401

S = 64  # frame size of the synthetic trees


# ---------------------------------------------------------------- PNG codec


def _filtered_png(img: np.ndarray) -> bytes:
    """An RGB PNG whose rows cycle through all five filter types, written
    here with the reference encodings of the PNG specification."""
    H, W, bpp = img.shape
    x = img.astype(np.int64)
    rows = []
    for r in range(H):
        ft = r % 5
        prev = x[r - 1] if r else np.zeros_like(x[0])
        left = np.concatenate([np.zeros((1, bpp), np.int64), x[r, :-1]])
        upleft = np.concatenate([np.zeros((1, bpp), np.int64), prev[:-1]])
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][ft]
        rows.append(np.concatenate([[ft], ((x[r] - pred) % 256).reshape(-1)]).astype(np.uint8))
    raw = np.stack(rows).tobytes()
    import struct
    import zlib

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("png")
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (23, 37, 3), np.uint8)
    rgb[:5] = rgb[:5] // 64 * 64  # runs of equal bytes: the encoder picks other filters there
    files = {
        "gray": (rng.randint(0, 256, (19, 31), np.uint8), cv2.imwrite),
        "rgb": (rgb, lambda p, a: cv2.imwrite(p, cv2.cvtColor(a, cv2.COLOR_RGB2BGR))),
        "rgba": (rng.randint(0, 256, (17, 13, 4), np.uint8), cv2.imwrite),
        "palette": (rgb, lambda p, a: Image.fromarray(a).convert(
            "P", palette=Image.ADAPTIVE, colors=40).save(p)),
        "gray_alpha": (rng.randint(0, 256, (11, 9, 2), np.uint8),
                       lambda p, a: Image.fromarray(a, "LA").save(p)),
    }
    paths = {}
    for name, (arr, write) in files.items():
        paths[name] = str(d / f"{name}.png")
        write(paths[name], arr)
    paths["filters"] = str(d / "filters.png")
    with open(paths["filters"], "wb") as f:
        f.write(_filtered_png(rgb))
    paths["jpeg"] = str(d / "frame.jpg")
    cv2.imwrite(paths["jpeg"], rgb)
    return paths


def _cv2_read(path, gray):
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return img if gray else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("name", ["gray", "rgb", "rgba", "palette", "gray_alpha", "filters"])
def test_png_decoder_matches_cv2_and_native(png_files, name):
    """Colour reads equal cv2's and the native decoder's exactly; so do gray
    reads of gray files. A colour file read as gray takes the native
    decoder's formula exactly; cv2 5 converts through libpng's own integer
    weights, within 1 of it (the allowance tests/test_native_io.py makes)."""
    path = png_files[name]
    io = native.get_io()
    for gray in (False, True):
        got = png.read_png(path, gray=gray)
        want = _cv2_read(path, gray)
        assert got.dtype == np.uint8 and got.shape == want.shape
        if gray and name not in ("gray", "gray_alpha"):
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(got, want)
        if io is not None:
            np.testing.assert_array_equal(got, io.decode(path, gray=gray))


def test_png_refuses_what_it_does_not_take(png_files, tmp_path):
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(png_files["jpeg"])
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        png.read_png(deep)


@pytest.mark.parametrize("shape", [(21, 34), (21, 34, 3)], ids=["gray", "rgb"])
def test_png_encoder_round_trip(tmp_path, shape):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back if back.ndim == 2 else cv2.cvtColor(back, cv2.COLOR_BGR2RGB),
                                  img)
    np.testing.assert_array_equal(png.read_png(path, gray=len(shape) == 2), img)


# ------------------------------------------------- postprocess, metrics, evaluator


@pytest.mark.parametrize("out_hw", [(90, 75), (30, 20), (60, 50)], ids=["up", "down", "crop"])
def test_postprocess_matches_jax(out_hw):
    """Bilinear through F.interpolate against cv2's INTER_LINEAR within 1e-5
    of max |output| (cv2 rounds its interpolation weights to float32 in its
    own order), nearest labels exactly, cropping the (60, 50) valid region
    first."""
    rng = np.random.RandomState(2)
    sem = rng.randn(3, 2, 64, 64).astype(np.float32)
    gt = rng.randint(0, 2, (3, 64, 64)).astype(np.uint8)
    gt[:, 60:] = 255
    got = postprocess.sem_seg_postprocess(sem, (60, 50), *out_hw)
    want = jpost.sem_seg_postprocess(sem, (60, 50), *out_hw)
    assert got.shape == want.shape == (3, 2, *out_hw) and got.dtype == want.dtype
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(postprocess.sem_seg_postprocess(sem[0], (60, 50), *out_hw),
                               want[0], rtol=0, atol=tol)
    g, w = (postprocess.crop_and_resize_gt(gt, (60, 50), *out_hw),
            jpost.crop_and_resize_gt(gt, (60, 50), *out_hw))
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


def _metric_inputs(seed, nan=False):
    rng = np.random.RandomState(seed)
    pred = rng.rand(4, 24, 24)
    gt = (rng.rand(4, 24, 24) > 0.6).astype(np.uint8)
    gt[1] = 0  # an empty frame: the no-object IoU rule, skipped by max-F
    if nan:
        pred[2, :5] = np.nan  # a diverged model's output
    return pred, gt


@pytest.mark.parametrize("nan", [False, True])
def test_metrics_match_jax(nan):
    pred, gt = _metric_inputs(3, nan)
    ignore = np.zeros_like(gt, bool)
    ignore[:, :, :3] = True
    for ig in (None, ignore):
        assert metrics.mask_iou(pred, gt, ignore=ig) == jmetrics.mask_iou(pred, gt, ignore=ig)
        assert metrics.eval_fmeasure(pred, gt, ignore=ig) == jmetrics.eval_fmeasure(
            pred, gt, ignore=ig)
    rng = np.random.RandomState(4)
    scores, labels = rng.rand(3, 5, 16, 16), rng.randint(0, 5, (3, 16, 16))
    labels[0, :2] = 255
    for ig in (None, 255):
        for a, b in zip(metrics.batch_miou_fscore(scores, labels, 5, ignore_label=ig),
                        jmetrics.batch_miou_fscore(scores, labels, 5, ignore_label=ig)):
            np.testing.assert_array_equal(a, b)


def test_evaluator_matches_jax():
    """process, merge and evaluate of the S4 evaluator, inline and through
    per-video partials, with padded GT and a NaN video, equal the JAX ones."""
    rng = np.random.RandomState(5)
    ports, jaxes = evaluator.SemSegEvaluator(), jevaluator.SemSegEvaluator()
    merged = evaluator.SemSegEvaluator()
    for v in range(3):
        sem = rng.randn(5, 2, 32, 32).astype(np.float32)
        if v == 2:
            sem[1, 1, :4] = np.nan
        gt = (rng.rand(5, 32, 32) > 0.5).astype(np.uint8)
        gt[:, 28:] = 255
        ports.process(sem, gt)
        jaxes.process(sem, gt)
        part = evaluator.eval_video_partial(sem, gt, (28, 32), 40, 48)
        assert part._count == 1
        merged.merge(part)
        jpart = jevaluator.eval_video_partial("sem_seg", 2, sem, gt, (28, 32), 40, 48)
        assert (part._miou_sum, part._f_sum) == (jpart._miou_sum, jpart._f_sum)
    assert ports.evaluate() == jaxes.evaluate()
    assert merged._count == 3 and set(merged.evaluate()["sem_seg"]) == {"mIoU", "f_score"}


def test_verify_results_and_csv(caplog):
    res = {"sem_seg": {"mIoU": 0.5, "f_score": 0.25}}
    assert verify_results(res, [["sem_seg", "mIoU", 0.5, 1e-4]])
    with pytest.raises(AssertionError):
        verify_results(res, [["sem_seg", "f_score", 0.5, 1e-4]])
    with caplog.at_level("INFO", logger="COMBO"):
        print_csv_format(res)
    assert "copypaste: 0.5000,0.2500" in caplog.text


# ----------------------------------------------- catalog, mapper, loader


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A tiny synthetic S4 tree written by the port (1 train, 3 val videos
    of 5 frames at 64^2), registered in both packages' catalogs."""
    root = str(tmp_path_factory.mktemp("s4tree"))
    s4 = make_s4(root, 1, 3, size=S)
    catalogs.register_all(root)
    pre = os.path.join(s4, "pre_SAM_mask")
    jcatalogs.register("port_tree_s4_val", lambda: jcatalogs.load_avss4_records(s4, "val", pre),
                       dict(jcatalogs.MetadataCatalog.get("avss4_sem_seg_val", {}),
                            evaluator_type="sem_seg"))
    return root, s4


@pytest.mark.parametrize("split", ["train", "val"])
def test_catalog_matches_jax(tree, split):
    root, s4 = tree
    got = catalogs.DatasetCatalog[f"avss4_sem_seg_{split}"]()
    want = jcatalogs.load_avss4_records(s4, split, os.path.join(s4, "pre_SAM_mask"))
    assert got == want and len(got) == (1 if split == "train" else 3)
    assert catalogs.MetadataCatalog["avss4_sem_seg_val"]["evaluator_type"] == "sem_seg"


def test_mapper_and_loader_match_jax(tree):
    records = catalogs.DatasetCatalog["avss4_sem_seg_val"]()
    port = AVSSemanticDatasetMapper(size_divisibility=S)
    jax_mapper = JaxMapper(is_train=False, size_divisibility=S, max_instances=3,
                           binary_gt=True, use_pre_sam=True)
    for rec in records:
        got, want = port(rec), jax_mapper(rec)
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the padding of a frame smaller than the size: 128 for pixels, 255 for GT
    big = AVSSemanticDatasetMapper(size_divisibility=S + 8)(records[0])
    assert (big["images"][:, S:] == 128).all() and (big["sem_segs"][:, S:] == 255).all()
    assert big["image_size"].tolist() == [S, S]
    batches = list(eval_loader(records, port, batch_size=2))
    assert [len(r) for _, r in batches] == [2, 1]
    assert batches[0][0]["images"].shape == (2, 5, S, S, 3)
    # padded: the last batch filled with a copy of its last video, marked
    (_, last), = list(eval_loader(records, port, batch_size=2, pad=True))[1:]
    assert [r.get("_pad", False) for r in last] == [False, True]
    assert last[1]["file_names"] == last[0]["file_names"]


# --------------------------------------------------------------- pool


def _hang(pid_file):
    with open(pid_file, "w") as f:
        f.write(str(os.getpid()))
    time.sleep(120)


def test_pool_kills_a_hung_worker(tmp_path):
    """A worker that returns nothing within the timeout is killed with the
    rest of the pool before the error is raised."""
    pool = MetricPool(2, timeout=1.0)
    pid_file = str(tmp_path / "pid")
    pool.submit(_hang, pid_file)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="killed"):
        pool.drain(evaluator.SemSegEvaluator())
    assert time.perf_counter() - t0 < 30
    with open(pid_file) as f:
        pid = int(f.read())
    with pytest.raises(ProcessLookupError):  # killed and reaped
        os.kill(pid, 0)


# ----------------------------------------------------------- checkpoints


@pytest.fixture(scope="module")
def tiny():
    jm = graft._flagship_model(tiny=True)
    port = init_weights(MaskFormer(**_port_kwargs(jm), device="cpu"), seed=0).eval()
    return jm, port


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)


def test_reference_checkpoint_round_trip(tiny, tmp_path):
    jm, port = tiny
    path = str(tmp_path / "model_best.pth")
    checkpoint.save_reference_checkpoint(port, path)
    fresh = MaskFormer(**_port_kwargs(jm), device="cpu")
    checkpoint.load_reference_checkpoint(fresh, path)
    _same_weights(fresh, port)

    # a d2-style .pkl of numpy arrays with metadata; the pre-SAM tower
    # missing, so the visual tower fills both
    sd = {k: v.numpy() for k, v in port.state_dict().items()
          if not k.startswith("pre_sam_backbone.")}
    pkl = str(tmp_path / "model.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"model": sd, "__author__": "test", "iteration": 7}, f)
    fresh = MaskFormer(**_port_kwargs(jm), device="cpu")
    checkpoint.load_reference_checkpoint(fresh, pkl)
    for k, v in fresh.state_dict().items():
        src = k.replace("pre_sam_backbone.", "backbone.", 1)
        torch.testing.assert_close(v, port.state_dict()[src], rtol=0, atol=0, msg=k)


def test_reference_checkpoint_is_strict(tiny, tmp_path):
    """Past the criterion's keys, which the reference model carries and the
    loader drops, an unexpected or a missing key raises."""
    jm, port = tiny
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    sd["criterion.empty_weight"] = torch.ones(3)
    sd["sem_seg_head.predictor.extra.weight"] = torch.ones(3)
    path = str(tmp_path / "extra.pth")
    torch.save({"model": sd}, path)
    with pytest.raises(ValueError, match=r"1 unexpected keys \['sem_seg_head.predictor.extra"):
        checkpoint.load_reference_checkpoint(MaskFormer(**_port_kwargs(jm), device="cpu"), path)
    del sd["sem_seg_head.predictor.extra.weight"], sd["sem_seg_head.predictor.class_embed.bias"]
    torch.save(sd, path)
    with pytest.raises(ValueError, match="missing keys.*class_embed.bias"):
        checkpoint.load_reference_checkpoint(MaskFormer(**_port_kwargs(jm), device="cpu"), path)


def test_reference_layout_checkpoint_matches_jax(tiny, tmp_path):
    """A file laid out as the reference's `model_best.pth` ({"model": the
    MaskFormer's state dict, its criterion's `empty_weight` buffer
    included}, plus training metadata) loads through the port's loader and
    through the JAX package's `load_torch_file` + `convert_combo_checkpoint`;
    the two forwards on the same batch agree within the eval slice's fp32
    bound (tests/test_torch_slice.py: atol 5e-3, rtol 1e-3)."""
    jm, port = tiny
    empty_weight = torch.ones(jm.num_classes + 1)
    empty_weight[-1] = 0.1  # eos_coef
    path = str(tmp_path / "model_best.pth")
    torch.save({"model": {**port.state_dict(), "criterion.empty_weight": empty_weight},
                "optimizer": {}, "scheduler": {}, "iteration": 7}, path)
    fresh = MaskFormer(**_port_kwargs(jm), device="cpu")
    checkpoint.load_reference_checkpoint(fresh, path)
    _same_weights(fresh, port)
    variables = convert_combo_checkpoint(load_torch_file(path), dec_layers=jm.dec_layers,
                                         enc_layers=jm.enc_layers)
    batch = _batch(2)
    want = np.asarray(jax_make_eval_step(jm, (S, S))(variables["params"], variables["frozen"],
                                                     batch))
    got = make_eval_step(fresh.eval(), (S, S))(batch)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=1e-3)


# ------------------------------------------------------------- the slice


def test_evaluate_matches_jax(tree, tiny, tmp_path, monkeypatch):
    """The port's evaluate and the JAX package's, fp32 on the CPU, the tiny
    flagship on the same weights (via convert_combo_checkpoint), over the 3
    synthetic val videos at batch 2 (one duplicate fills the last batch).
    The semantic maps agree within the eval slice's fp32 bound (atol 5e-3,
    tests/test_torch_slice.py), which moves a pixel only within that of the
    0.5 threshold: mIoU and F-score, rounded to 4 decimals, within 2e-3.
    The metric pool (COMBO_EVAL_PROCS=2) gives the inline numbers exactly,
    and the results file is written."""
    jm, port = tiny
    variables = convert_combo_checkpoint({k: v.numpy() for k, v in port.state_dict().items()},
                                         dec_layers=jm.dec_layers, enc_layers=jm.enc_layers)
    cfg = get_cfg()
    cfg.INPUT.SIZE_DIVISIBILITY = S
    cfg.MODEL.PRE_SAM.USE_PRE_SAM = True
    cfg.TEST.BF16 = False
    cfg.OUTPUT_DIR = ""
    want = jax_evaluate(cfg, jm, variables["params"], variables["frozen"], "port_tree_s4_val",
                        batch_size=2)["sem_seg"]
    before = seminf_cuda.launches
    got, timing = evaluate(port, "avss4_sem_seg_val", batch_size=2, size=S,
                           output_dir=str(tmp_path))
    assert seminf_cuda.launches == before
    assert set(got["sem_seg"]) == set(want) == {"mIoU", "f_score"}
    for k, v in want.items():
        assert abs(got["sem_seg"][k] - v) <= 2e-3, (k, got["sem_seg"][k], v)
    assert timing["videos"] == 3 and timing["frames"] == 15
    saved = torch.load(str(tmp_path / "inference" / "avss4_sem_seg_val" /
                           "sem_seg_evaluation.pth"))
    assert saved == got["sem_seg"]
    monkeypatch.setenv("COMBO_EVAL_PROCS", "2")
    pooled, _ = evaluate(port, "avss4_sem_seg_val", batch_size=2, size=S)
    assert pooled == got


def test_pred_cli(tiny, tmp_path, monkeypatch, capsys):
    """python -m combo_avs_torch.pred on one synthetic 224^2 video, on the
    CPU: arguments, the catalog, the checkpoint, evaluate and the printed
    result. The CLI builds MaskFormer()'s full width, which the CPU tests
    replace with the tiny flagship's."""
    import combo_avs_torch.models.meta_arch as meta_arch
    from combo_avs_torch import pred

    jm, port = tiny
    root = str(tmp_path / "data")
    make_s4(root, 0, 1)
    path = str(tmp_path / "model_best.pth")
    checkpoint.save_reference_checkpoint(port, path)
    monkeypatch.setattr(meta_arch, "MaskFormer", lambda device=None: MaskFormer(
        **_port_kwargs(jm), device=device))
    res = pred.main(["--datasets-root", root, "--checkpoint", path, "--dataset",
                     "avss4_sem_seg_val", "--batch-size", "2", "--device", "cpu",
                     "--output-dir", str(tmp_path / "out")])
    assert set(res["sem_seg"]) == {"mIoU", "f_score"}
    assert "avss4_sem_seg_val {'mIoU'" in capsys.readouterr().out
    assert os.path.isfile(tmp_path / "out" / "inference" / "avss4_sem_seg_val" /
                          "sem_seg_evaluation.pth")
