"""Configuration: the reference's layered config, read without yaml.

Port of `combo_avs_tpu/config.py` (ref: models/config.py:6-149,
train_net.py:231-247): a recursive attribute dict (`CfgNode`), the same
default key surface (`get_cfg`), `_BASE_` file inheritance with deep merge,
command-line overrides (`merge_from_list`) and `setup_cfg`. The shipped
configs under `combo_avs_tpu/configs/` are read in place, as data.

The shipped files are block YAML as `yaml.safe_dump` writes them
(`combo_avs_tpu/configs/_generate.py`); upstream and users' files add a few
more forms. `read_yaml` reads, with the standard library alone: block
mappings, block sequences (indented or not under their key), plain scalars
resolved as PyYAML's SafeLoader resolves them (null, bool, decimal int,
float, str), single- and double-quoted scalars (keys too) on one line,
anchors (`&a`) and aliases (`*a`) of any node, flow sequences and flow
mappings on one line, nested in each other, comments, and the reference's
`!!python/object/apply:eval ["expr"]` tag, evaluated as the JAX reader
does with no builtins but int, range and float. A key repeated in one
mapping deep-merges into the first (the reference's S4 base file repeats
`MODEL:`). Tuples written as strings (`TRAIN: ("x",)`, `SIZE: (224, 224)`)
become tuples. Anything else raises ValueError rather than being misread:
other tags, merge keys, block scalars, multi-line flow collections and
quoted scalars, compact nested block collections, several documents, and
the number forms other than decimal.

One default differs on purpose: MODEL.DEVICE is "cuda" (the JAX package
says "tpu"), and the entry points run on the card unless the config or the
caller asks for the CPU.
"""

from __future__ import annotations

import ast
import copy
import os
import re
from typing import Any, Iterator, List, Tuple

_RESERVED = {"_frozen_", "_dict_"}


class CfgNode:
    """Recursive attribute dict with freeze semantics."""

    def __init__(self, init: dict | None = None):
        object.__setattr__(self, "_dict_", {})
        object.__setattr__(self, "_frozen_", False)
        if init:
            for k, v in init.items():
                self[k] = v

    def __getitem__(self, key: str) -> Any:
        return self._dict_[key]

    def __setitem__(self, key: str, value: Any) -> None:
        if self._frozen_:
            raise AttributeError(f"CfgNode is frozen; cannot set {key!r}")
        if isinstance(value, dict):
            value = CfgNode(value)
        self._dict_[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._dict_

    def __iter__(self) -> Iterator[str]:
        return iter(self._dict_)

    def keys(self):
        return self._dict_.keys()

    def items(self):
        return self._dict_.items()

    def values(self):
        return self._dict_.values()

    def get(self, key: str, default: Any = None) -> Any:
        return self._dict_.get(key, default)

    def __getattr__(self, key: str) -> Any:
        if key in _RESERVED:
            return object.__getattribute__(self, key)
        try:
            return self._dict_[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any) -> None:
        if key in _RESERVED:
            object.__setattr__(self, key, value)
        else:
            self[key] = value

    def freeze(self) -> "CfgNode":
        object.__setattr__(self, "_frozen_", True)
        for v in self._dict_.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        object.__setattr__(self, "_frozen_", False)
        for v in self._dict_.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        new = CfgNode()
        for k, v in self._dict_.items():
            new[k] = copy.deepcopy(v, memo)
        if self._frozen_:
            new.freeze()
        return new

    def merge_dict(self, other: dict) -> None:
        """Deep-merge a plain dict into this node (other wins)."""
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self._dict_.get(k), CfgNode):
                self._dict_[k].merge_dict(v)
            else:
                self[k] = v

    def merge_from_file(self, path: str) -> None:
        self.merge_dict(_eval_tuple_strings(load_yaml_with_base(path)))

    def merge_from_list(self, opts: list) -> None:
        """Merge ``["KEY.SUBKEY", value, ...]`` pairs (command-line style);
        string values are read as Python literals where they parse."""
        if len(opts) % 2:
            raise ValueError(f"override list must be key/value pairs: {opts}")
        for key, value in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass
            node[parts[-1]] = value

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v for k, v in self._dict_.items()}

    def __repr__(self) -> str:
        return f"CfgNode({self.to_dict()!r})"


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

# PyYAML's implicit resolvers (yaml/resolver.py) for the plain scalars read
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
# the other numbers PyYAML resolves (octal, hex, binary, sexagesimal, .inf,
# .nan): refused rather than read as strings
_OTHER_NUMBER = re.compile(r"[-+]?(?:0[0-7_]+$|0x|0b|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
                           r"|\.(?:inf|Inf|INF)$)|\.(?:nan|NaN|NAN)$")


EVAL_TAG = "!!python/object/apply:eval"
# the builtins the eval tag's expression may call (combo_avs_tpu/config.py:157-166)
EVAL_BUILTINS = {"int": int, "range": range, "float": float}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _plain(s: str) -> Any:
    """A plain scalar, resolved as PyYAML's SafeLoader resolves it; any
    other YAML construct raises."""
    if s[:1] and s[0] in "'\"&*!|>{}[]%@`?,#" or s == "-" or s.startswith("- ") \
            or ": " in s or s.endswith(":"):
        raise ValueError(f"YAML construct not read: {s!r} (block scalars, tags other than "
                         f"{EVAL_TAG}, directives and reserved indicators are not read)")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _OTHER_NUMBER.match(s):
        raise ValueError(f"YAML number form not read: {s!r}")
    return s


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[i] -> (its value, the index after the
    closing quote); single quotes double to escape, double quotes take
    YAML's backslash escapes. It must close on its line."""
    q, out, i = s[i], [], i + 1
    while i < len(s):
        c = s[i]
        if c == q:
            if q == "'" and s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if c == "\\" and q == '"':
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise ValueError(f"bad escape in {s!r}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                raise ValueError(f"bad escape in {s!r}")
            continue
        out.append(c)
        i += 1
    raise ValueError(f"quoted scalar not closed on its line (multi-line scalars are not "
                     f"read): {s!r}")


class _Flow:
    """A flow node (`[...]`, `{...}`, quoted, plain, anchored or aliased)
    on one line, read from `s[i:]`."""

    def __init__(self, s: str, anchors: dict):
        self.s, self.i, self.anchors = s, 0, anchors

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self, stops: str) -> Any:
        """The node at the cursor, up to one of `stops` (flow plain scalars
        end at `,`, `]`, `}` and `: `)."""
        self.ws()
        s = self.s
        anchor = None
        if s.startswith("&", self.i):
            m = re.compile(r"&([^\s,\[\]{}]+)").match(s, self.i)
            anchor, self.i = m.group(1), m.end()
            self.ws()
        if s.startswith("*", self.i):
            m = re.compile(r"\*([^\s,\[\]{}]+)").match(s, self.i)
            if anchor or m.group(1) not in self.anchors:
                raise ValueError(f"unknown YAML alias in {s!r}")
            self.i = m.end()
            return self.anchors[m.group(1)]
        if s.startswith("!", self.i):
            value = self._tagged()
        elif s.startswith("[", self.i):
            value = self._sequence()
        elif s.startswith("{", self.i):
            value = self._mapping()
        elif s.startswith(("'", '"'), self.i):
            value, self.i = _quoted(s, self.i)
        else:
            j = self.i
            while j < len(s) and s[j] not in stops and not (
                    s[j] == ":" and (j + 1 == len(s) or s[j + 1] in " ,[]{}")):
                j += 1
            text, self.i = s[self.i:j].strip(), j
            value = _plain(text) if text else None
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def _tagged(self):
        if not self.s.startswith(EVAL_TAG, self.i):
            raise ValueError(f"YAML tag not read: {self.s!r} (only {EVAL_TAG})")
        self.i += len(EVAL_TAG)
        self.ws()
        if not self.s.startswith("[", self.i):
            raise ValueError(f"{EVAL_TAG} takes a flow sequence here: {self.s!r}")
        return _eval_tag(self._sequence())

    def _sequence(self) -> list:
        self.i += 1
        out: list = []
        while True:
            self.ws()
            if self.s.startswith("]", self.i):
                self.i += 1
                return out
            out.append(self.node(",]"))
            self._separator("]")

    def _mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.ws()
            if self.s.startswith("}", self.i):
                self.i += 1
                return out
            key = self.node(",}:")
            self.ws()
            value = None
            if self.s.startswith(":", self.i):
                self.i += 1
                value = self.node(",}")
            _put(out, key, value)
            self._separator("}")

    def _separator(self, close: str):
        self.ws()
        if self.s.startswith(",", self.i):
            self.i += 1
        elif not self.s.startswith(close, self.i):
            raise ValueError(f"malformed YAML flow collection: {self.s!r}")


def _eval_tag(args) -> Any:
    """The reference's `!!python/object/apply:eval [expr]`, evaluated as the
    JAX reader does: no globals but int, range and float."""
    if not isinstance(args, list) or len(args) != 1 or not isinstance(args[0], str):
        raise ValueError(f"{EVAL_TAG} takes one string, got {args!r}")
    return eval(args[0], {"__builtins__": EVAL_BUILTINS})  # noqa: S307


def _put(out: dict, key: Any, value: Any) -> None:
    """A mapping entry; a repeated key deep-merges into the first when both
    are mappings (the JAX reader's mapping constructor)."""
    if isinstance(key, (dict, list)):
        raise ValueError(f"YAML mapping key not read: {key!r}")
    if key == "<<":
        raise ValueError("YAML merge keys (<<) are not read")
    if key in out and isinstance(out[key], dict) and isinstance(value, dict):
        out[key] = _deep_merge(out[key], value)
    else:
        out[key] = value


def _scalar(s: str, anchors: dict) -> Any:
    """The value text of one line: one flow node, which must fill it."""
    f = _Flow(s, anchors)
    value = f.node("")
    f.ws()
    if f.i != len(s):
        raise ValueError(f"YAML construct not read: {s!r}")
    return value


def _split_key(text: str) -> Tuple[Any, str] | None:
    """(key, rest) when `text` is a mapping entry `key: rest` (the key plain
    or quoted), else None."""
    if text[:1] in ("'", '"'):
        try:
            key, j = _quoted(text, 0)
        except ValueError:
            return None
        m = re.compile(r" *:(?: +(.*)|$)").match(text, j)
        return (key, (m.group(1) or "").strip()) if m else None
    m = re.match(r"(.*?):(?: +(.*)|$)", text)
    if not m or text[:1] in "[{&*!":
        return None
    return _plain(m.group(1).strip()), (m.group(2) or "").strip()


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class _Lines:
    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines, self.pos = lines, 0
        self.anchors: dict = {}

    def peek(self) -> Tuple[int, str] | None:
        return self.lines[self.pos] if self.pos < len(self.lines) else None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(src: _Lines, indent: int) -> Any:
    """The block node whose first line is at `indent`."""
    ind, text = src.peek()
    if _is_item(text):
        return _sequence(src, ind)
    if _split_key(text) is not None:
        return _mapping(src, ind)
    src.pos += 1
    return _scalar(text, src.anchors)


_PROPERTIES = re.compile(r"(?:&(?P<anchor>[^\s,\[\]{}]+))?\s*(?P<tag>!\S+)?$")


def _value_after(src: _Lines, rest: str, indent: int, seq_ok: bool) -> Any:
    """The value of an entry whose text after the indicator is `rest`: inline,
    or the block on the following, deeper lines (a sequence may sit at the
    key's own indent when `seq_ok`), with its anchor and the eval tag when
    `rest` holds only those."""
    props = _PROPERTIES.match(rest) if rest[:1] in "&!" else None
    if rest and props is None:
        return _scalar(rest, src.anchors)
    nxt = src.peek()
    value = None
    if nxt is not None:
        ind, text = nxt
        if ind > indent or (seq_ok and ind == indent and _is_item(text)):
            value = _block(src, ind)
    if props is not None and props.group("tag"):
        if props.group("tag") != EVAL_TAG:
            raise ValueError(f"YAML tag not read: {props.group('tag')} (only {EVAL_TAG})")
        value = _eval_tag(value)
    if props is not None and props.group("anchor"):
        src.anchors[props.group("anchor")] = value
    return value


def _mapping(src: _Lines, indent: int) -> dict:
    out: dict = {}
    while (line := src.peek()) is not None:
        ind, text = line
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"bad indentation at {text!r}")
        entry = _split_key(text)
        if entry is None:
            break
        key, rest = entry
        src.pos += 1
        _put(out, key, _value_after(src, rest, indent, seq_ok=True))
    return out


def _sequence(src: _Lines, indent: int) -> list:
    out: list = []
    while (line := src.peek()) is not None:
        ind, text = line
        if ind != indent or not _is_item(text):
            break
        src.pos += 1
        rest = text[1:].strip()
        if _is_item(rest) or (_split_key(rest) is not None and rest[:1] not in "'\"[{"):
            raise ValueError(f"YAML construct not read: {text!r} (compact nested sequences "
                             "and mappings in a sequence are not read)")
        out.append(_value_after(src, rest, indent, seq_ok=False))
    return out


def _strip_comment(raw: str) -> str:
    """The line without its comment: a `#` at the start or after a space,
    outside quotes."""
    quote = None
    for j, c in enumerate(raw):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (j == 0 or raw[j - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (j == 0 or raw[j - 1] in " \t"):
            return raw[:j]
    return raw


def read_yaml(text: str) -> dict:
    """Parse the YAML forms described in the module docstring."""
    lines: List[Tuple[int, str]] = []
    for raw in text.splitlines():
        if re.match(r"(?:---|\.\.\.)(?:\s|$)|%", raw):
            raise ValueError(f"YAML documents and directives are not read: {raw!r}")
        line = _strip_comment(raw).rstrip()
        body = line.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError("tab indentation is not YAML")
        if body:
            lines.append((len(line) - len(body), body))
    if not lines:
        return {}
    src = _Lines(lines)
    node = _block(src, lines[0][0])
    if src.peek() is not None:
        raise ValueError(f"unexpected YAML line {src.peek()[1]!r}")
    if not isinstance(node, dict):
        raise ValueError("a config file's top level must be a mapping")
    return node


def _eval_tuple_strings(obj):
    """The reference files write tuples as strings (`TRAIN: ("x",)`,
    `SIZE: (224, 224)`); evaluate those to tuples, recursively."""
    if isinstance(obj, dict):
        return {k: _eval_tuple_strings(v) for k, v in obj.items()}
    if isinstance(obj, str):
        s = obj.strip()
        if s.startswith("(") and s.endswith(")"):
            try:
                return ast.literal_eval(s)
            except (ValueError, SyntaxError):
                return obj
    return obj


def load_yaml_with_base(path: str) -> dict:
    """A config file with its `_BASE_` chain resolved (a relative base is
    taken from the file's own directory); the file's keys win."""
    with open(path) as f:
        cfg = read_yaml(f.read())
    base = cfg.pop("_BASE_", None)
    if base is not None:
        base_path = base if os.path.isabs(base) else os.path.join(os.path.dirname(path), base)
        cfg = _deep_merge(load_yaml_with_base(base_path), cfg)
    return cfg


# ---------------------------------------------------------------------------
# defaults: the same key surface as combo_avs_tpu/config.py::get_cfg
# ---------------------------------------------------------------------------


def get_cfg() -> CfgNode:
    c = CfgNode()

    c.VERSION = 2
    c.OUTPUT_DIR = "./output"
    c.SEED = -1

    m = c.MODEL = CfgNode()
    m.META_ARCHITECTURE = "MaskFormer"
    m.DEVICE = "cuda"
    m.WEIGHTS = ""
    m.PIXEL_MEAN = [123.675, 116.280, 103.530]
    m.PIXEL_STD = [58.395, 57.120, 57.375]

    m.BACKBONE = CfgNode()
    m.BACKBONE.NAME = "build_resnet_backbone"
    m.BACKBONE.FREEZE_AT = 0

    m.RESNETS = CfgNode()
    m.RESNETS.DEPTH = 50
    m.RESNETS.NORM = "FrozenBN"
    m.RESNETS.STEM_TYPE = "basic"
    m.RESNETS.STEM_OUT_CHANNELS = 64
    m.RESNETS.RES2_OUT_CHANNELS = 256
    m.RESNETS.STRIDE_IN_1X1 = False
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.RESNETS.RES5_MULTI_GRID = [1, 1, 1]

    m.PVT = CfgNode()
    m.PVT.NAME = "b5"
    m.PVT.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.PVT.DROP_PATH_RATE = 0.1

    m.SWIN = CfgNode()  # key surface kept for config compatibility; not built
    m.SWIN.OUT_FEATURES = ["res2", "res3", "res4", "res5"]

    m.AUDIO = CfgNode()
    m.AUDIO.FREEZE_AUDIO_EXTRACTOR = True
    m.AUDIO.PRETRAINED_VGGISH_MODEL_PATH = "pretrained/vggish-10086976.pth"
    m.AUDIO.PREPROCESS_AUDIO_TO_LOG_MEL = False
    m.AUDIO.POSTPROCESS_LOG_MEL_WITH_PCA = False
    m.AUDIO.PRETRAINED_PCA_PARAMS_PATH = "pretrained/vggish_pca_params-970ea276.pth"
    # scales the VGGish conv and FC widths (the embedding stays 128); 1.0 is
    # the reference architecture, smaller values only for tests
    m.AUDIO.WIDTH_MULT = 1.0

    m.FUSE_CONFIG = CfgNode()
    m.FUSE_CONFIG.FUSION_STEP = "early"
    m.FUSE_CONFIG.TYPE = "MHA-B"
    m.FUSE_CONFIG.AUDIO_DIM = 1024
    m.FUSE_CONFIG.FUSED_BACKBONE = []
    m.FUSE_CONFIG.FUSED_BACKBONE_DIM = []
    m.FUSE_CONFIG.NUM_FRAMES = 5
    m.FUSE_CONFIG.QUERIES_FUSE_TYPE = "add"
    m.FUSE_CONFIG.AUDIO_OUT_DIM = 256

    m.MOBILE_SAM = CfgNode()
    m.MOBILE_SAM.USE_MOBILE_SAM = False
    m.MOBILE_SAM.CHECKPOINT = ""

    m.PRE_SAM = CfgNode()
    m.PRE_SAM.USE_PRE_SAM = False
    m.PRE_SAM.PRE_SAM_DIM = [256, 512, 1024, 2048]
    m.PRE_SAM.PRE_SAM_FEATURE_SIZE = [56, 28, 14, 7]

    h = m.SEM_SEG_HEAD = CfgNode()
    h.NAME = "MaskFormerHead"
    h.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    h.IGNORE_VALUE = 255
    h.NUM_CLASSES = 2
    h.LOSS_WEIGHT = 1.0
    h.CONVS_DIM = 256
    h.MASK_DIM = 256
    h.NORM = "GN"
    h.COMMON_STRIDE = 4
    h.PIXEL_DECODER_NAME = "MSDeformAttnPixelDecoder"
    h.TRANSFORMER_ENC_LAYERS = 6
    h.DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES = ["res3", "res4", "res5"]
    h.DEFORMABLE_TRANSFORMER_ENCODER_N_POINTS = 4
    h.DEFORMABLE_TRANSFORMER_ENCODER_N_HEADS = 8

    f = m.MASK_FORMER = CfgNode()
    f.TRANSFORMER_DECODER_NAME = "MultiScaleMaskedTransformerDecoder"
    f.TRANSFORMER_IN_FEATURE = "multi_scale_pixel_decoder"
    f.DEEP_SUPERVISION = True
    f.NO_OBJECT_WEIGHT = 0.1
    f.CLASS_WEIGHT = 1.0
    f.DICE_WEIGHT = 1.0
    f.MASK_WEIGHT = 20.0
    f.COSINE_WEIGHT = 1.0
    f.NHEADS = 8
    f.DROPOUT = 0.1
    f.DIM_FEEDFORWARD = 2048
    f.ENC_LAYERS = 0
    f.DEC_LAYERS = 6
    f.PRE_NORM = False
    f.HIDDEN_DIM = 256
    f.NUM_OBJECT_QUERIES = 100
    f.ENFORCE_INPUT_PROJ = False
    f.SIZE_DIVISIBILITY = 32
    f.TRAIN_NUM_POINTS = 112 * 112
    f.OVERSAMPLE_RATIO = 3.0
    f.IMPORTANCE_SAMPLE_RATIO = 0.75
    # False: the stratified uncertain-point selection where the shapes divide
    # (`losses/criterion.py::uncertainty_sampled_points`); True: exact top-k
    f.EXACT_TOPK_POINTS = False
    # the JAX package's pixel-decoder remat policy; kept for config
    # compatibility, the port keeps every activation
    f.REMAT_POLICY = "save_deform"
    f.TEST = CfgNode()
    f.TEST.SEMANTIC_ON = True
    f.TEST.INSTANCE_ON = False
    f.TEST.PANOPTIC_ON = False
    f.TEST.OBJECT_MASK_THRESHOLD = 0.0
    f.TEST.OVERLAP_THRESHOLD = 0.0
    f.TEST.SEM_SEG_POSTPROCESSING_BEFORE_INFERENCE = False

    i = c.INPUT = CfgNode()
    i.AUGMENTATION = True
    i.MIN_SIZE_TRAIN = [224]
    i.MIN_SIZE_TRAIN_SAMPLING = "choice"
    i.MIN_SIZE_TEST = 224
    i.MAX_SIZE_TRAIN = 896
    i.MAX_SIZE_TEST = 896
    i.CROP = CfgNode()
    i.CROP.ENABLED = False
    i.CROP.TYPE = "absolute"
    i.CROP.SIZE = (224, 224)
    i.CROP.SINGLE_CATEGORY_MAX_AREA = 1.0
    i.COLOR_AUG_SSD = False
    i.SIZE_DIVISIBILITY = -1
    i.FORMAT = "RGB"
    i.DATASET_MAPPER_NAME = "avss4_semantic"
    i.RANDOM_FLIP = "horizontal"
    i.IMAGE_SIZE = 1024
    i.MIN_SCALE = 0.1
    i.MAX_SCALE = 2.0

    c.DATASETS = CfgNode()
    c.DATASETS.TRAIN = ("avss4_sem_seg_train",)
    c.DATASETS.TEST = ("avss4_sem_seg_val",)
    c.DATALOADER = CfgNode()
    c.DATALOADER.NUM_WORKERS = 8
    c.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    s = c.SOLVER = CfgNode()
    s.IMS_PER_BATCH = 8
    s.BASE_LR = 0.0001
    s.MAX_ITER = 90000
    s.WARMUP_FACTOR = 1.0
    s.WARMUP_ITERS = 0
    s.WEIGHT_DECAY = 0.05
    s.WEIGHT_DECAY_NORM = 0.0
    s.WEIGHT_DECAY_EMBED = 0.0
    s.OPTIMIZER = "ADAMW"
    s.LR_SCHEDULER_NAME = "WarmupPolyLR"
    s.POLY_LR_POWER = 0.9
    s.POLY_LR_CONSTANT_ENDING = 0.0
    s.BACKBONE_MULTIPLIER = 0.1
    s.MOMENTUM = 0.9
    s.CHECKPOINT_PERIOD = 5000
    s.CLIP_GRADIENTS = CfgNode()
    s.CLIP_GRADIENTS.ENABLED = False
    s.CLIP_GRADIENTS.CLIP_TYPE = "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 0.01
    s.CLIP_GRADIENTS.NORM_TYPE = 2.0
    s.AMP = CfgNode()
    s.AMP.ENABLED = False

    t = c.TEST = CfgNode()
    t.EVAL_PERIOD = 5000
    # evaluation precision: "auto" runs bf16 on the card and fp32 on the
    # CPU; True / False force it
    t.BF16 = "auto"
    t.AUG = CfgNode()
    t.AUG.ENABLED = False
    t.AUG.MIN_SIZES = [128, 224, 384]
    t.AUG.MAX_SIZE = 1536
    t.AUG.FLIP = True
    # [[task, metric, expected, tolerance], ...], checked by verify_results
    # after --eval-only (ref: train_net.py:262)
    t.EXPECTED_RESULTS = []

    return c


def setup_cfg(config_file: str | None = None, opts: list | None = None,
              freeze: bool = True) -> CfgNode:
    """Defaults <- the config file (with its `_BASE_` chain) <- overrides."""
    cfg = get_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    if freeze:
        cfg.freeze()
    return cfg
