"""The yardstick's counts: the model FLOPs against FlopCounterMode on the
reference, each port op's bytes against its tensors."""

import pytest
import torch
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import spec
from h100_bench.counts import model as counts, port_ops
from h100_bench.reference import model as ref_model
from h100_bench.tests import tiny


@pytest.mark.parametrize("config", ["combo_pvtv2b5_ms3", "combo_r50_s4"])
def test_model_flops_match_flop_counter(config, monkeypatch):
    name = {"combo_pvtv2b5_ms3": "pvt_ms3_train", "combo_r50_s4": "r50_s4_train"}[config]
    c = tiny.cell(name, monkeypatch)
    m, t = c["config"]["model"], dict(c["workload"]["traffic"], videos=1)
    ref = ref_model.build(m, "cpu").train()
    S, T = t["size"], t["frames"]
    g = torch.Generator().manual_seed(0)
    # the math attention, whose products the counter sees (it has no entry
    # for the CPU's fused attention kernel)
    with sdpa_kernel(SDPBackend.MATH), FlopCounterMode(display=False) as fc:
        ref(torch.randint(0, 256, (1, T, S, S, 3), dtype=torch.uint8),
            torch.randn(1, T, 96, 64), torch.randint(0, 256, (1, T, S, S, 3), dtype=torch.uint8), g)
    per = counts.forward_per_frame(m, S)
    assert fc.get_total_flops() == T * sum(per.values())
    assert counts.step_flops(m, t, "train") == T * (3 * (per["towers"] + per["head"])
                                                  + per["vggish"])


def test_full_size_flops_are_the_published_scale():
    pvt = spec.load_json(f"{spec.PKG}/configs/combo_pvtv2b5_ms3.json")["model"]
    # PVTv2-B5 at 224^2: 11.8 GMAC a tower (Wang et al., PVTv2, Table 1)
    tower = counts.pvtv2(224)[0] / 2
    assert 11.0e9 < tower < 12.2e9
    r50 = counts.resnet50(224)[0] / 2
    assert 4.0e9 < r50 < 4.2e9  # ResNet-50: 4.1 GMAC
    assert counts.step_flops(pvt, {"videos": 8, "frames": 5, "size": 224}, "train") > 5e12


def test_port_op_bytes_are_the_tensors():
    value = torch.zeros(4, 1029, 8, 32)
    loc = torch.zeros(4, 1029, 8, 3, 4, 2)
    attw = torch.zeros(4, 1029, 8, 3, 4)
    out = torch.zeros(4, 1029, 256)
    b = port_ops.call_bound("k1_deform_fwd", (value, ((28, 28), (14, 14), (7, 7)), loc, attw),
                            {}, out)
    assert b["bytes"] == 4 * (value.numel() + loc.numel() + attw.numel() + out.numel())
    assert b["flops"] == 2 * 32 * 4 * attw.numel()
    assert b["bound_s"] == pytest.approx(b["bytes"] / 3.35e12)
    feat, pts = torch.zeros(6, 56, 56, 1), torch.zeros(6, 100, 2)
    b = port_ops.call_bound("k3_k5_point_fwd", (feat, pts), {}, torch.zeros(6, 100, 1))
    assert b["bytes"] == 4 * (feat.numel() + pts.numel() + 600)
    cls, mask = torch.zeros(2, 100, 2), torch.zeros(2, 100, 56, 56, dtype=torch.bfloat16)
    b = port_ops.call_bound("k7_seminf", (cls, mask, (224, 224), None), {},
                            torch.zeros(2, 2, 224, 224))
    assert b["bytes"] == 4 * cls.numel() + 2 * mask.numel() + 4 * 2 * 2 * 224 * 224
    assert b["flops"] == 2 * 224 * 224 * 100 * (12 + 4)


def test_kernel_names_fall_in_their_layer():
    assert port_ops.port_op("void ms_deform_attn_fwd_staged<float, 8>(float const*)") == \
        "k1_deform_fwd"
    assert port_ops.port_op("void (anonymous namespace)::point_sample_dimg_staged<4>(...)") == \
        "k4_point_dimg"
    assert port_ops.port_op("void gather_kernel<long, 4>(float2 const*)") == "k6_gather"
    assert port_ops.port_op("void at::native::_scatter_gather_elementwise_kernel<128>") is None
    assert port_ops.category("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT") == "gemm_conv"
    assert port_ops.category("sm90_xmma_fprop_implicit_gemm_tf32f32") == "gemm_conv"
    assert port_ops.category("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "allreduce"
    assert port_ops.category("void at::native::vectorized_elementwise_kernel<4>") == "other"
