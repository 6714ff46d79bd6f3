"""The port's FeedForward routing against the JAX package's, and what
``chip_smoke.py`` holds K3 and K4 to on the card: their bounds, their
library yardsticks (and those of K8 and the K8 pair) and the widths that
reach every instance of K3's launcher."""
import pathlib
import re

import numpy as np
import pytest
import torch

from magicdrive_tpu.config import presets as jp
from magicdrive_tpu.kernels import geglu as jgg

torch.set_num_threads(1)

_JAX_PRESETS = ("sd15mv_rawbox_224x400", "sd15mv_rawbox_272x736",
                "sd15mv_rawbox_424x800", "sd15mv_rawbox_video_16f",
                "tiny_debug", "micro_debug", "small_parity",
                "tiny_video_debug")
# the FF width of every JAX preset's transformers, and one that the rule
# sends to K3 at bf16 and to K4 at fp32
_FF_WIDTHS = sorted({C for n in _JAX_PRESETS
                     for C in getattr(jp, n)().unet.block_out_channels}
                    | {424})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", _FF_WIDTHS)
def test_feedforward_routes_by_the_input_element_size(C, dtype,
                                                      monkeypatch):
    """The port's FeedForward calls K3 (``autograd.fused_ff``) exactly where
    JAX's ``ff_full_fusion_fits(C, 4C, C, itemsize)`` holds for the input's
    element size, else K4 (``autograd.fused_geglu``) and the stage-2
    linear."""
    from magicdrive_tpu_torch.core.transformer import FeedForward
    from magicdrive_tpu_torch.kernels import autograd

    calls = []

    def fake_ff(x, w1, b1, w2):
        calls.append("fused_ff")
        return x.new_zeros(*x.shape[:-1], w2.shape[0])

    def fake_geglu(x, w1, b1):
        calls.append("fused_geglu")
        return x.new_zeros(*x.shape[:-1], w1.shape[0] // 2)

    monkeypatch.setattr(autograd, "fused_ff", fake_ff)
    monkeypatch.setattr(autograd, "fused_geglu", fake_geglu)
    with torch.device("meta"):  # the routing needs shapes, not weights
        ff = FeedForward(C).to(dtype)
    ff(torch.zeros(1, 3, C, dtype=dtype, device="meta"))
    itemsize = torch.tensor([], dtype=dtype).element_size()
    want = "fused_ff" if jgg.ff_full_fusion_fits(C, 4 * C, C, itemsize) \
        else "fused_geglu"
    assert calls == [want]


def test_the_widths_that_route_differently_by_element_size():
    """C=424 is one of the widths whose route the element size decides:
    K3 at bf16, K4 at fp32."""
    assert jgg.ff_full_fusion_fits(424, 4 * 424, 424, 2)
    assert not jgg.ff_full_fusion_fits(424, 4 * 424, 424, 4)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("M,K,N,C", [(24, 16, 64, 16), (30, 40, 96, 24)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_ff_bounds_count_the_products_and_each_tensor_once(M, K, N, C,
                                                           with_bias):
    """K4's operations are 2*M*K*2N (value and gate halves), K3's add
    2*M*N*C for stage 2; their bytes count each input once and the output
    once (K3's gated product never leaves the function)."""
    import chip_smoke

    x, w1, w2 = _bf16(M, K), _bf16(2 * N, K), _bf16(C, N)
    b1 = _bf16(2 * N) if with_bias else None
    nb = 2 * N if with_bias else 0
    geglu = (x, w1, b1)
    assert chip_smoke._flops("fused_geglu", geglu) == 2 * M * K * 2 * N
    assert chip_smoke._bytes("fused_geglu", geglu, _bf16(M, N)) == \
        2 * (M * K + 2 * N * K + nb + M * N)
    ff = (x, w1, b1, w2)
    assert chip_smoke._flops("fused_ff", ff) == \
        2 * M * K * 2 * N + 2 * M * N * C
    assert chip_smoke._bytes("fused_ff", ff, _bf16(M, C)) == \
        2 * (M * K + 2 * N * K + nb + C * N + M * C)
    ms, by = chip_smoke.bound("fused_ff", ff, _bf16(M, C))
    assert by in ("bytes", "operations") and ms > 0


def _normal(*shape, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("name", ["fused_ff", "fused_geglu"])
def test_composed_ff_yardsticks_match_the_plain_versions(name, with_bias):
    """composed_ms of K3 and K4 times F.linear, chunk, exact GELU times the
    value half and (K3) F.linear by W2; in fp32 on the CPU that computes
    their function."""
    import chip_smoke
    from magicdrive_tpu_torch.kernels import reference

    M, K, N, C = 37, 24, 96, 24
    args = (_normal(M, K, seed=1), _normal(2 * N, K, scale=K ** -0.5, seed=2),
            _normal(2 * N, scale=0.1, seed=3) if with_bias else None)
    if name == "fused_ff":
        args += (_normal(C, N, scale=N ** -0.5, seed=4),)
    torch.testing.assert_close(chip_smoke.COMPOSED[name](*args),
                               getattr(reference, name)(*args),
                               atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("name", ["fused_qkv_attention",
                                  "fused_qkv_out_attention"])
def test_composed_k7_k8_yardsticks_match_the_plain_versions(name):
    """K7's yardstick is K1's composition; K8's adds F.linear by Wout."""
    import chip_smoke
    from magicdrive_tpu_torch.kernels import reference

    B, Lq, Lk, C, Ck, H, D, C_out = 2, 19, 11, 24, 40, 2, 8, 20
    wout = (_normal(C_out, H * D, scale=(H * D) ** -0.5, seed=11),) \
        if "_out_" in name else ()
    args = (_normal(B, Lq, C, seed=6), _normal(B, Lk, Ck, seed=7),
            _normal(H * D, C, scale=C ** -0.5, seed=8),
            _normal(H * D, Ck, scale=Ck ** -0.5, seed=9),
            _normal(H * D, Ck, scale=Ck ** -0.5, seed=10), *wout, H,
            D ** -0.5)
    torch.testing.assert_close(chip_smoke.COMPOSED[name](*args),
                               getattr(reference, name)(*args),
                               atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("shifts", [(5, 1, 6), (1, 2, 6)])
def test_composed_k8_pair_yardstick_matches_the_plain_version(shifts):
    """The K8 pair's yardstick: K2's composition, then F.linear by Wout."""
    import chip_smoke
    from magicdrive_tpu_torch.kernels import reference

    B, L, C, H, D, C_out = 12, 13, 24, 2, 8, 28
    args = (_normal(B, L, C, seed=12),
            *(_normal(H * D, C, scale=C ** -0.5, seed=13 + i)
              for i in range(3)),
            _normal(C_out, H * D, scale=(H * D) ** -0.5, seed=16), H,
            D ** -0.5, reference.ring_table(shifts[:2], shifts[2]))
    torch.testing.assert_close(
        chip_smoke.COMPOSED["fused_qkv_out_attention_pair"](*args),
        reference.fused_qkv_out_attention_pair(*args), atol=2e-4, rtol=2e-3)


def test_every_kernel_of_the_path_has_a_yardstick():
    """Every kernel that check_kernels runs has a composition to time, and
    the bitwise two-call check covers the redesigned K1-K4, K7, K8 and the
    K8 pair."""
    import chip_smoke

    flash = {"flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv"}
    assert set(chip_smoke.KERNELS) - flash == set(chip_smoke.COMPOSED)
    assert set(chip_smoke.REDESIGNED) == {
        "kvstat_attention", "kvstat_attention_pair", "fused_ff",
        "fused_geglu", "fused_qkv_attention", "fused_qkv_out_attention",
        "fused_qkv_out_attention_pair"}


def test_ff_widths_reach_every_instance_of_the_launcher():
    """check_ff_widths runs K3 at one width for each instance of its
    launcher's switch (MDK_FF_CASE), up to the largest C the K3 rule
    accepts at bf16, with a C that is not a multiple of 16; K4 at the
    path's widths and one that is not a multiple of 64."""
    import chip_smoke
    from magicdrive_tpu_torch.kernels import dispatch

    src = pathlib.Path(chip_smoke.__file__).parent / \
        "magicdrive_tpu_torch/kernels/csrc/geglu.cu"
    compiled = {int(n) for n in re.findall(r"MDK_FF_CASE\((\d+)\)",
                                           src.read_text())}
    k3 = chip_smoke.FF_WIDTHS["fused_ff"]
    assert compiled == set(range(1, 6))
    assert {chip_smoke.ff_instance(C) for C in k3} == compiled
    largest = max(C for C in range(8, 2048, 8)
                  if dispatch.ff_full_fusion_fits(C, 4 * C, C, 2))
    assert max(k3) == largest == 576
    assert all(dispatch.ff_full_fusion_fits(C, 4 * C, C, 2) for C in k3)
    assert any(C % 16 for C in k3)
    assert all(C % 8 == 0 for C in k3)
    k4 = chip_smoke.FF_WIDTHS["fused_geglu"]
    assert {640, 1280} <= set(k4) and any(C % 64 for C in k4)
