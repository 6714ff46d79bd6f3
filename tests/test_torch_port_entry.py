"""The port's entry points build on the card unless the caller asks for the
CPU, and raise where there is no card; the bounds ``chip_smoke.py`` computes
for the flash kernels and for K1/K2 from a call's shapes; and its K1/K2
library yardsticks and depth list."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_create_defaults_to_the_card_and_raises_without_one(no_card):
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules

    with pytest.raises(RuntimeError, match="no CUDA card"):
        MagicDriveModules.create(tiny_debug())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        MagicDriveModules.create(tiny_debug(), device="cuda:0")


def test_create_train_state_defaults_to_the_card_and_raises_without_one(
        no_card):
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import TrainConfig, create_train_state

    modules = MagicDriveModules.create(tiny_debug(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        create_train_state(modules, TrainConfig())
    # nothing moved before the refusal
    assert all(p.dtype == torch.float32 for _, m in modules.items()
               for p in m.parameters())


def test_chip_smoke_names_the_failing_phase(no_card, capsys):
    """Without a card the script's first phase fails: one line on stdout
    names it, and no result line follows."""
    import chip_smoke

    with pytest.raises(SystemExit):
        chip_smoke.main()
    assert capsys.readouterr().out.splitlines() == [
        "chip_smoke FAILED in environment: SystemExit: chip_smoke: no CUDA "
        "device (torch.cuda.is_available() is False)"]


def test_frozen_snapshot_at_another_dtype_raises():
    """A frozen-weight snapshot taken before the train state casts the
    modules to bf16 would report every frozen weight changed, led by the
    UNet's time embedding and conv_in; chip_smoke's comparison refuses it,
    and a snapshot taken after the cast finds nothing changed."""
    import chip_smoke
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import TrainConfig, create_train_state

    torch.manual_seed(0)
    modules = MagicDriveModules.create(tiny_debug(), device="cpu")
    with torch.no_grad():
        for _, m in modules.items():
            for p in m.parameters():
                p.add_(0.1 * torch.randn_like(p))
    before = chip_smoke._frozen(modules)
    create_train_state(modules, TrainConfig(), device="cpu")
    stale = [k for k, t in chip_smoke._frozen(modules).items()
             if not torch.equal(t, before[k])]
    assert stale[:5] == ["unet.time_embedding.linear_1.weight",
                         "unet.time_embedding.linear_1.bias",
                         "unet.time_embedding.linear_2.weight",
                         "unet.time_embedding.linear_2.bias",
                         "unet.conv_in.weight"]
    with pytest.raises(AssertionError, match="another dtype"):
        chip_smoke.frozen_changed(modules, before)
    assert chip_smoke.frozen_changed(modules,
                                     chip_smoke._frozen(modules)) == []


@pytest.mark.parametrize("bf16_floor", [False, True])
def test_call_checker_holds_each_output_to_its_own_scale(bf16_floor):
    """The per-call check of a kernel with outputs of scales 1e-3 and 1e3
    (a backward's dq and dk, say) held 5e-3 from its plain version in each
    passes, with or without the plain bf16 version as a floor; 5e-2 off in
    the small output alone fails."""
    import chip_smoke

    def plain(x):
        return x * 1e-3, x * 1e3

    def make_kernel(off):
        return lambda x: tuple(o * (1 + e) for o, e in
                               zip(plain(x), off))

    x = torch.linspace(-1, 1, 64).to(torch.bfloat16)
    stats = {}
    check = chip_smoke._call_checker(stats, bf16_floor)
    check("k", make_kernel((5e-3, 5e-3)), plain)(x)
    # calls, then each distance / max|ref|: kernel to fp32, and with the
    # floor kernel to plain bf16 and plain bf16 to fp32
    assert stats["k"][0] == 1 and max(stats["k"][1:]) < 1e-2
    with pytest.raises(AssertionError, match="max|ref|"):
        check("k", make_kernel((5e-2, 0.0)), plain)(x)


def test_entry_points_build_on_the_cpu_when_asked():
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import TrainConfig, create_train_state

    modules = MagicDriveModules.create(tiny_debug(), device="cpu")
    tensors = [t for _, m in modules.items()
               for t in (*m.parameters(), *m.buffers())]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    state = create_train_state(modules, TrainConfig(), device="cpu",
                               dtype=torch.bfloat16)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in state.masters.values())
    assert all(p.dtype == torch.bfloat16 for _, m in modules.items()
               for p in m.parameters())


@pytest.mark.parametrize("name,per_lq_lk_d", [
    ("flash_attention_fwd", 4), ("flash_attention_bwd_dq", 6),
    ("flash_attention_bwd_dkv", 8), ("flash_attention_bwd", 10)])
@pytest.mark.parametrize("Lk,kv_len", [(40, 40), (48, 33)])
def test_flash_bound_counts_the_keys_below_kv_len(name, per_lq_lk_d, Lk,
                                                  kv_len):
    """The operations of a flash call are per_lq_lk_d * BH * Lq * kv_len *
    D: the whole K6 counts s, dp, dv, dk and dq once each, and keys past
    kv_len need no work. Its bytes count each input once and each output
    once, with only the kv_len rows of k and v that the kernels read."""
    import chip_smoke

    BH, Lq, D = 3, 24, 16

    def rows(L):
        return torch.zeros(BH, L, D, dtype=torch.bfloat16)

    def stat():  # an fp32 row statistic: lse, delta
        return torch.zeros(BH, Lq)

    q, k, v, o, do, lse, delta = (rows(Lq), rows(Lk), rows(Lk), rows(Lq),
                                  rows(Lq), stat(), stat())
    args, out = {
        "flash_attention_fwd": ((q, k, v, kv_len), (o, lse)),
        "flash_attention_bwd_dq": ((q, k, v, o, lse, do, kv_len),
                                   (rows(Lq), stat())),
        "flash_attention_bwd_dkv": ((q, k, v, lse, delta, do, kv_len),
                                    (rows(Lk), rows(Lk))),
        "flash_attention_bwd": ((q, k, v, o, lse, do, kv_len),
                                (rows(Lq), rows(Lk), rows(Lk))),
    }[name]
    assert chip_smoke._flops(name, args) == \
        per_lq_lk_d * BH * Lq * kv_len * D
    # bf16 tensors of q rows and of key rows, fp32 row statistics
    n_q, n_k, n_stat = {"flash_attention_fwd": (2, 0, 1),
                        "flash_attention_bwd_dq": (4, 0, 2),
                        "flash_attention_bwd_dkv": (2, 2, 2),
                        "flash_attention_bwd": (4, 2, 1)}[name]
    assert chip_smoke._bytes(name, args, out) == \
        2 * BH * D * (n_q * Lq + 2 * kv_len + n_k * Lk) + n_stat * 4 * BH * Lq
    ms, by = chip_smoke.bound(name, args, out)
    assert by in ("bytes", "operations") and ms > 0


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("Lq,Lk,C,Ck,H,D", [
    (24, 24, 16, 16, 2, 8), (24, 10, 16, 40, 2, 8), (30, 17, 32, 24, 4, 16)])
@pytest.mark.parametrize("self_attention", [True, False])
def test_k1_bound_counts_each_projection_once(Lq, Lk, C, Ck, H, D,
                                              self_attention):
    """K1's operations: q, k and v projected once, q k^T and p v per head;
    its bytes: each distinct input once (x_q read once where it is also
    x_kv, as at attn1) and the output once, with k and v, which never leave
    the function, not counted. K1's kv projection alone counts its own."""
    import chip_smoke

    B = 3
    if self_attention:
        Lk, Ck = Lq, C
    x_q = _bf16(B, Lq, C)
    x_kv = x_q if self_attention else _bf16(B, Lk, Ck)
    HD = H * D
    wq, wk, wv = _bf16(HD, C), _bf16(HD, Ck), _bf16(HD, Ck)
    args, out = (x_q, x_kv, wq, wk, wv, H, D ** -0.5), _bf16(B, Lq, HD)
    assert chip_smoke._flops("kvstat_attention", args) == \
        2 * B * (Lq * C + 2 * Lk * Ck) * HD + 4 * B * Lq * Lk * HD
    x_bytes = B * Lq * C + (0 if self_attention else B * Lk * Ck)
    assert chip_smoke._bytes("kvstat_attention", args, out) == \
        2 * (x_bytes + HD * C + 2 * HD * Ck + B * Lq * HD)
    kv = (x_kv, wk, wv)
    assert chip_smoke._flops("kv_project", kv) == 2 * B * Lk * Ck * 2 * HD
    assert chip_smoke._bytes("kv_project", kv, (_bf16(B, H, Lk, D),
                                                _bf16(B, H, Lk, D))) == \
        2 * (B * Lk * Ck + 2 * HD * Ck + 2 * B * Lk * HD)


@pytest.mark.parametrize("L,C,H,D", [(24, 16, 2, 8), (30, 32, 4, 16)])
def test_k2_bound_counts_projections_once_and_attention_per_neighbour(
        L, C, H, D):
    """The pair's neighbours share k and v, so the projections count once;
    q k^T and p v count once per neighbour. x is read once, the output
    written once, and the neighbour table (2 x 6 int32) read once."""
    import chip_smoke
    from magicdrive_tpu_torch.kernels import reference

    B, HD = 6, H * D
    x, w = _bf16(B, L, C), [_bf16(HD, C) for _ in range(3)]
    args = (x, *w, H, D ** -0.5, reference.ring_table((5, 1), 6))
    assert chip_smoke._flops("kvstat_attention_pair", args) == \
        2 * B * 3 * L * C * HD + 2 * 4 * B * L * L * HD
    assert chip_smoke._bytes("kvstat_attention_pair", args,
                             _bf16(B, L, HD)) == \
        2 * (B * L * C + 3 * HD * C + B * L * HD) + 4 * 2 * 6


def _normal(*shape, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale)


def test_composed_k1_yardstick_matches_the_plain_version():
    """composed_ms times F.linear projections and one SDPA call; in fp32 on
    the CPU that computes K1's function."""
    import chip_smoke
    from magicdrive_tpu_torch.kernels import reference

    B, Lq, Lk, C, Ck, H, D = 2, 19, 11, 24, 40, 2, 8
    args = (_normal(B, Lq, C, seed=1), _normal(B, Lk, Ck, seed=2),
            _normal(H * D, C, scale=C ** -0.5, seed=3),
            _normal(H * D, Ck, scale=Ck ** -0.5, seed=4),
            _normal(H * D, Ck, scale=Ck ** -0.5, seed=5), H, D ** -0.5)
    torch.testing.assert_close(chip_smoke.composed_kvstat_attention(*args),
                               reference.kvstat_attention(*args),
                               atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("shifts", [(5, 1, 6), (1, 2, 6)])
def test_composed_k2_yardstick_matches_the_plain_version(shifts):
    """The pair's yardstick, two SDPA calls on the table-gathered k/v
    summed in fp32, computes K2's function under both rings' tables."""
    import chip_smoke
    from magicdrive_tpu_torch.kernels import reference

    B, L, C, H, D = 12, 13, 24, 2, 8
    args = (_normal(B, L, C, seed=6),
            *(_normal(H * D, C, scale=C ** -0.5, seed=7 + i)
              for i in range(3)), H, D ** -0.5,
            reference.ring_table(shifts[:2], shifts[2]))
    torch.testing.assert_close(
        chip_smoke.composed_kvstat_attention_pair(*args),
        reference.kvstat_attention_pair(*args), atol=2e-4, rtol=2e-3)


def test_attention_depths_reach_every_instance_of_the_launcher():
    """check_attention_depths runs K1 and K2 at one depth for each head
    depth the K1/K2 launcher's switch compiles (D padded to a multiple of
    16), each a depth the wrappers take (a multiple of 8), with padded
    ones among them."""
    import pathlib
    import re

    import chip_smoke

    src = pathlib.Path(chip_smoke.__file__).parent / \
        "magicdrive_tpu_torch/kernels/csrc/proj_attend.cuh"
    compiled = {int(n) for n in re.findall(r"MDK_KVSTAT_CASE\((\d+)\)",
                                           src.read_text())}
    depths = chip_smoke.ATTENTION_DEPTHS
    assert compiled == set(range(16, 129, 16))
    assert {(d + 15) // 16 * 16 for d in depths} == compiled
    assert all(d % 8 == 0 for d in depths)
    assert any(d % 16 for d in depths)


@pytest.mark.parametrize("M,K,N", [(37, 80, 72), (200, 16, 8)])
def test_out_project_bound_counts_the_product_and_each_tensor_once(M, K, N):
    """The out-projection alone does 2*M*K*N operations and moves o, Wout
    and y once each."""
    import chip_smoke

    o, wout, y = _bf16(M, K), _bf16(N, K), _bf16(M, N)
    assert chip_smoke._flops("out_project", (o, wout)) == 2 * M * K * N
    assert chip_smoke._bytes("out_project", (o, wout), y) == \
        2 * (M * K + N * K + M * N)


def test_profiled_kernel_names_are_kernels_of_the_csrc():
    """Every name the profiled guided and training steps sum by
    (chip_smoke.PROFILED) is a __global__ function of kernels/csrc, so a
    renamed kernel fails here rather than reading 0 ms on the card; the
    auto step's attention names the out-projection beside the heads."""
    import pathlib
    import re

    import chip_smoke

    csrc = pathlib.Path(chip_smoke.__file__).parent / \
        "magicdrive_tpu_torch/kernels/csrc"
    kernels = {m for p in csrc.iterdir() for m in re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        p.read_text())}
    names = {n for parts in chip_smoke.PROFILED.values() for n in parts}
    assert names <= kernels, names - kernels
    assert {"kvstat_kernel", "out_project_kernel", "flash_fwd_kernel",
            "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"} <= names


def test_attention_depths_reach_the_out_projection_edges():
    """check_attention_depths out-projects K8 and its pair to a width that
    the kernel takes (a multiple of 8) but is not a multiple of its 64-column
    tile, and at one depth H*D = 80 (two heads of 40), not a multiple of its
    64-deep chunk."""
    import chip_smoke

    assert chip_smoke.OUT_WIDTH % 8 == 0 and chip_smoke.OUT_WIDTH % 64
    assert 40 in chip_smoke.ATTENTION_DEPTHS


def test_profiled_parts_read_the_kernel_names_the_profiler_prints():
    """_device_ms finds each kernel under the names torch.profiler gives
    them on the card (a template's arguments, an anonymous namespace, a
    plain function) and counts no other kernel of a similar name."""
    import chip_smoke

    rows = [(1.0, 14, "void mdk::kvstat_kernel<48, 1>(__nv_bfloat16 const*"),
            (2.0, 5, "void mdk::kvstat_kernel<48, 2>(__nv_bfloat16 const*"),
            (4.0, 31, "mdk::kv_project_kernel(__nv_bfloat16 const*, int)"),
            (8.0, 40, "mdk::out_project_kernel(CUtensorMap_st, int)"),
            (16.0, 23, "void mdk::(anonymous namespace)::flash_fwd_kernel"
                       "<48>(__nv_bfloat16 const*"),
            (32.0, 23, "void mdk::(anonymous namespace)::"
                       "flash_bwd_dkv_kernel<48>(__nv_bfloat16 const*"),
            (64.0, 23, "void mdk::(anonymous namespace)::"
                       "flash_bwd_dq_kernel<48>(__nv_bfloat16 const*"),
            (128.0, 7, "void mdk::ff_kernel<5>(CUtensorMap_st)"),
            (256.0, 16, "mdk::geglu_kernel(CUtensorMap_st)"),
            (512.0, 9, "void at::native::elementwise_kernel<128, 4>()")]
    want = {"heads": 3.0, "kv_project": 4.0, "out_project": 8.0, "K5": 16.0,
            "K6": 96.0, "K3": 128.0, "K4": 256.0}
    assert {p: chip_smoke._device_ms(rows, p) for p in want} == want
