"""The fp32 instances of the port's kernels (``kernels/csrc/f32_*.cu``), on
the CPU: their C entries against the ctypes signatures, the dtype rules of
the wrappers (every floating tensor bf16 or every one fp32, each wrapper's
fp32 call to its ``_f32`` entry), the plain versions at fp32 against the
JAX Pallas kernels at fp32 in interpret mode (the JAX package runs its
Pallas kernels at the element size of an fp32 run; every bf16 cast point
is then the identity) at the head depths 40, 80 and 128, atol 2e-4 / rtol
2e-3, and the launches an fp32 train step of the 224x400 routing makes
against ``chip_smoke.expected_launches`` at esize 4. The kernels
themselves run on the card only (``chip_smoke.py``).
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from magicdrive_tpu_torch.kernels import build, dispatch, reference

from test_torch_port_kernels import (_ff_weights, _flash_inputs, _t, _unpad,
                                     _weights, gathered, jfa, jfl, jgg,
                                     table_of)

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 2e-3
DEPTHS = (40, 80, 128)


def _c_entries():
    """{name: parameter count} of every function defined in an
    ``extern "C"`` block of kernels/csrc."""
    out = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"',
                                text, re.S):
            for m in re.finditer(r"^[\w\s\*]*?\b(mdk_\w+)\(([^)]*)\)\s*\{",
                                 block, re.M):
                params = [p for p in m.group(2).split(",") if p.strip()]
                out[m.group(1)] = len(params)
    return out


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_signature_has_its_c_definition(name):
    """Each ctypes signature, bf16 and ``_f32``, names an ``extern "C"``
    function of kernels/csrc with as many parameters: ctypes would pass a
    wrong count without a word."""
    entries = _c_entries()
    assert name in entries, f"{name} has no extern \"C\" definition"
    assert entries[name] == len(build._SIGNATURES[name][1])


def test_every_kernel_entry_has_an_fp32_instance():
    entries = _c_entries()
    for name in build.KERNEL_ENTRIES:
        assert name in entries and name + "_f32" in entries
    assert {p.name for p in build.CSRC.glob("f32_*")} == {
        "f32_tile.cuh", "f32_attention.cu", "f32_geglu.cu", "f32_flash.cu"}


def test_fp32_ff_launcher_has_the_bf16_instances():
    """The fp32 K3 launcher (csrc/f32_geglu.cu) compiles one instance for
    each count of 64-column output tiles a block, 1 to 5, as the bf16 one,
    and spreads the tiles by the same rule (``chip_smoke.ff_instance``), so
    ``check_ff_widths`` reaches each fp32 instance too."""
    import chip_smoke

    src = (build.CSRC / "f32_geglu.cu").read_text()
    compiled = {int(n) for n in re.findall(r"MDK_FF_F32_CASE\((\d+)\)",
                                           src)}
    assert compiled == set(range(1, 6))
    assert int(re.search(r"FF_MAX_NC = (\d+);", src).group(1)) == 5
    widths = chip_smoke.FF_WIDTHS["fused_ff"]
    assert {chip_smoke.ff_instance(C) for C in widths} == compiled


def _f32_depths():
    """The depth instances of csrc/f32_tile.cuh MDK_F32_DEPTHS."""
    src = (build.CSRC / "f32_tile.cuh").read_text()
    block = re.search(r"#define MDK_F32_DEPTHS\(CASE\)(.*?)\n\n", src,
                      re.S).group(1)
    return tuple(int(n) for n in re.findall(r"CASE\((\d+)\)", block))


def test_fp32_attention_instances_match_the_spill_gate():
    """Every depth instance of MDK_F32_DEPTHS (the one list that
    ``chip_smoke.F32_DEPTH_INSTANCES`` mirrors) is compiled for K1/K2's
    heads (NSRC 1 and 2), for K5 in each of its FWD_GEOMETRIES, K6's dq and
    its dk/dv, each projection on every dual tile that ``on_dual_tile``
    dispatches, and ``chip_smoke.SPILL_GATED`` counts exactly those entry
    functions, so a missing or spilling instance fails the card's build."""
    import chip_smoke

    depths = _f32_depths()
    assert depths == chip_smoke.F32_DEPTH_INSTANCES
    att = (build.CSRC / "f32_attention.cu").read_text()
    flash = (build.CSRC / "f32_flash.cu").read_text()
    assert "MDK_F32_DEPTHS(MDK_HEADS_CASE)" in att
    assert "MDK_F32_DEPTHS(MDK_FLASH_CASE)" in flash
    assert set(re.findall(r"launch_heads<(\d)>\(", att)) == {"1", "2"}
    assert re.findall(r"on_dual_tile\(dual_tile\(([^,]+), ", att) == [
        "M", "M"]
    for k in ("kv_project", "out_project"):
        assert f"return launch_{k}<decltype(g)>(" in att
    assert len(_dual_tiles()) == len(chip_smoke.DUAL_TILES) == 4
    kernels = re.findall(r"^(flash_\w+_f32_kernel)\(Args a\)", flash, re.M)
    assert kernels == ["flash_fwd_f32_kernel", "flash_dq_f32_kernel",
                       "flash_dkv_f32_kernel"]
    geometries = int(re.search(r"constexpr int FWD_GEOMETRIES = (\d+);",
                               flash).group(1))
    assert geometries == len(chip_smoke.f32_fwd_geometries(40)) == 2
    assert "flash_fwd_f32_kernel<DP, 1>" in flash
    assert "flash_fwd_f32_kernel<DP, 0>" in flash
    assert chip_smoke.SPILL_GATED["f32_attention.cu"] == \
        2 * len(depths) + 2 * len(chip_smoke.DUAL_TILES)
    assert chip_smoke.SPILL_GATED["f32_flash.cu"] == \
        (geometries + 2) * len(depths)
    assert [chip_smoke.f32_depth_instance(d) for d in range(8, 129, 8)] == [
        next(i for i in depths if i >= d) for d in range(8, 129, 8)]


def _fwd_geometry_source():
    """K5's geometries as csrc/f32_flash.cu FwdGeom and csrc/f32_tile.cuh
    set them: (rows a thread of geometry 1 against 0, its blocks-an-SM
    rule, the rates {shallow: eff, deep: eff}, the shared-memory rule)."""
    flash = (build.CSRC / "f32_flash.cu").read_text()
    tile = (build.CSRC / "f32_tile.cuh").read_text()
    eff = re.search(r"EFF = GI == 0 \? 100 : DP <= 48 \? (\d+) : (\d+);",
                    flash)
    return (
        "TI = GI == 0 ? attend_ti(DP) : attend_ti(DP) / 2;" in flash,
        "GI == 0 ? attend_min_blocks(DP)\n              : smem_blocks(BYTES)"
        " < 4 ? smem_blocks(BYTES) : 4;" in flash,
        {True: int(eff.group(1)), False: int(eff.group(2))},
        "return (int)(233472 / (bytes + 1024));" in tile and
        "FLOATS = PB + G::W * 4 * G::TI * G::LP;" in tile)


def test_fp32_attention_tile_mirrors_the_geometry():
    """``chip_smoke.f32_attention_tile`` restates csrc/f32_tile.cuh
    AttnGeom (4 warps, 4 TI rows a warp; 32-row streamed tiles up to the
    instance 48, 16-row tiles deeper) with the rows a thread of the heads
    and dq (``attend_ti``) and of dk/dv (``dkv_ti``), and K5's two
    geometries (csrc/f32_flash.cu FwdGeom: attend_ti's rows or half,
    blocks an SM from the launch bound and the shared memory, the rates)
    with ``fwd_geometry``'s choice by whole waves; the card holds them to
    the library's ``mdk_*_f32_tile`` entries in ``check_f32_tiles``."""
    import chip_smoke

    src = (build.CSRC / "f32_tile.cuh").read_text()
    assert "SHALLOW = DP <= 48" in src
    assert "W = 4, TI = TI_" in src
    assert "KT = SHALLOW ? 32 : 16" in src
    assert "BR = 4 * TI * W" in src
    assert "return DP <= 48 ? 8 : 6;" in src
    assert "return DP <= 80 ? 3 : 2;" in src
    assert "return DP <= 48 ? 8 : 3;" in (build.CSRC / "f32_flash.cu"
                                          ).read_text()
    halves, blocks_rule, eff, smem_rule = _fwd_geometry_source()
    assert halves and blocks_rule and smem_rule
    assert eff == chip_smoke.F32_FWD_EFF
    for kernel in chip_smoke.F32_ATTENTION_KERNELS:
        for dp in _f32_depths():
            ti = 8 if dp <= 48 else 3 if kernel == "dkv" else 6
            keys = 32 if dp <= 48 else 16
            if kernel != "fwd":
                assert chip_smoke.f32_attention_tile(kernel, dp) == (
                    16 * ti, keys)
                continue
            geometries = chip_smoke.f32_fwd_geometries(dp)
            for g, ti_g in enumerate((ti, ti // 2)):
                floats = chip_smoke._attend_floats(dp, ti_g)
                fit = 233472 // (4 * floats + 1024)
                bound = (3 if dp <= 80 else 2) if g == 0 else 4
                assert geometries[g] == (16 * ti_g, min(bound, fit),
                                         100 if g == 0 else eff[dp <= 48])
                assert min(bound, fit) >= 1
            with pytest.raises(ValueError):
                chip_smoke.f32_attention_tile("fwd", dp)
    # AttendSmem's floats, by hand at the path's depths: q, stages, v^T, p
    assert chip_smoke._attend_floats(40, 8) == 128 * 44 + 4 * 32 * 44 + \
        40 * 36 + 128 * 40
    assert chip_smoke._attend_floats(80, 3) == 48 * 84 + 4 * 16 * 84 + \
        80 * 20 + 48 * 24
    # the choice: the busiest SM's rounds of each geometry's blocks, 0 at a
    # tie
    for BH, Lq, D in ((48, 350, 80), (144, 350, 80), (48, 1400, 40),
                      (144, 1400, 40), (16, 8000, 40), (4, 200, 48)):
        costs = []
        for rows, blocks, e in chip_smoke.f32_fwd_geometries(D):
            n = -(-BH * -(-Lq // rows) // 132)
            r = n % blocks
            t = n - r + (r if r >= 2 else 100 / 70 if r else 0)
            costs.append(t * rows * 100.0 / e)
        want = 1 if costs[1] < costs[0] else 0
        assert chip_smoke.fwd_geometry(BH, Lq, D) == want
        assert chip_smoke.f32_attention_tile("fwd", D, (BH, Lq))[0] == \
            chip_smoke.f32_fwd_geometries(D)[want][0]


@pytest.mark.parametrize("kernel", ["heads", "fwd", "dq", "dkv"])
def test_depth_checks_reach_every_fp32_tile_raggedly(kernel):
    """The fp32 depth checks (``check_attention_depths`` for the heads,
    ``check_flash_depths`` for K5 and K6) run every depth instance, so
    every tile ``f32_attention_tile`` returns, those of the 224x400 path's
    attentions and of FLASH_SHAPES among them, and K5 at each depth in each
    of its geometries (``flash_depth_grids``), and their q rows, keys and
    (for dk/dv) key blocks end ragged against each tile's block and
    streamed tile, with keys masked past kv_len < Lk for K6."""
    import chip_smoke

    depths = (chip_smoke.ATTENTION_DEPTHS if kernel == "heads"
              else chip_smoke.FLASH_DEPTHS)
    assert {chip_smoke.f32_depth_instance(d) for d in depths} == set(
        chip_smoke.F32_DEPTH_INSTANCES)
    BH, Lq, Lk, kv_len = chip_smoke.FLASH_DEPTH_SHAPE
    assert kv_len < Lk
    if kernel == "fwd":
        path = {(BH_, Lq_, D) for BH_, Lq_, _, D, _ in
                chip_smoke.FLASH_SHAPES + chip_smoke.FLASH_TRAIN_SHAPES}
        reached = set()
        for d in depths:
            grids = chip_smoke.flash_depth_grids(d)
            assert sorted(grids) == [0, 1]
            for g, bh in grids.items():
                tile = chip_smoke.f32_attention_tile("fwd", d, (bh, Lq))
                assert tile[0] == chip_smoke.f32_fwd_geometries(d)[g][0]
                assert Lq % tile[0] and kv_len % tile[1] and bh >= BH
                reached.add(tile)
        assert {chip_smoke.f32_attention_tile("fwd", D, (b, q))
                for b, q, D in path} <= reached
        return
    reached = {chip_smoke.f32_attention_tile(kernel, d) for d in depths}
    path = {D for *_, D in chip_smoke._path_attentions()} | {
        D for *_, D, _ in chip_smoke.FLASH_SHAPES}
    assert path == {40, 80}
    assert {chip_smoke.f32_attention_tile(kernel, d) for d in path} <= \
        reached
    for rows, tile in reached:
        if kernel == "heads":  # K1 at Lq=200, Lk=150; the pair at L=150
            assert 200 % rows and 150 % rows and 150 % tile
        elif kernel == "dkv":  # key blocks, q tiles
            assert Lk % rows and kv_len % rows and Lq % tile
        else:  # q blocks, key tiles
            assert Lq % rows and kv_len % tile


def test_k5_geometries_take_the_path_grids():
    """K5's grid-chosen geometry at the training path's grids (H100's 132
    SMs): half-size blocks where geometry 0 leaves most SMs one or two of
    their three blocks (BH=48, L=350: 192 blocks; 384 of 48 rows give
    every SM two or three), geometry 0 where its rounds are whole or the
    smaller blocks would take more of them (BH=48, L=1400; BH=144;
    L=8000); ``fwd_rates``' grids are whole rounds of the geometry they
    time on every SM, which ``fwd_geometry`` takes there; the cost is
    csrc/f32_tile.cuh's ``sm_rounds``."""
    import chip_smoke

    src = (build.CSRC / "f32_tile.cuh").read_text()
    assert f"constexpr int LONE_RATE = {chip_smoke.LONE_RATE};" in src
    assert "(r >= 2 ? (double)r : r == 1 ? 100.0 / LONE_RATE : 0.0)" in src
    assert "return sm_rounds(blocks, sms, F::BLOCKS) * F::BR * 100.0 / " \
        "F::EFF;" in (build.CSRC / "f32_flash.cu").read_text()
    assert [chip_smoke.sm_rounds(b, 132, 3) for b in (132, 264, 396, 528,
                                                      660)] == [
        100 / 70, 2, 3, 3 + 100 / 70, 5]
    assert chip_smoke.fwd_geometry(48, 350, 80) == 1
    assert chip_smoke.fwd_geometry(48, 1400, 40) == 0
    assert chip_smoke.fwd_geometry(144, 1400, 40) == 0
    assert chip_smoke.fwd_geometry(144, 350, 80) == 0
    assert chip_smoke.fwd_geometry(16, 8000, 40) == 0
    assert chip_smoke.FLASH_TRAIN_SHAPES == (
        (144, 1400, 1400, 40, 1400), (144, 350, 350, 80, 350))
    assert chip_smoke.TRAIN_VIEWS * 8 == 144
    for D, grids in chip_smoke.FWD_RATE_GRIDS.items():
        for g, (BH, L) in enumerate(grids):
            rows, blocks, _ = chip_smoke.f32_fwd_geometries(D)[g]
            assert chip_smoke.fwd_geometry(BH, L, D) == g
            assert L % rows == 0 and BH * (L // rows) % (132 * blocks) == 0


def _dual_tiles():
    """(rows, value columns, blocks an SM, rate) of each dual tile in the
    order of csrc/f32_tile.cuh ``on_dual_tile``, read from its
    ``using ... = DualTile<...>`` lines."""
    src = (build.CSRC / "f32_tile.cuh").read_text()
    order = re.findall(r"case (\d):\s*return f\((Dual\w+)\{\}\);", src)
    assert [int(i) for i, _ in order] == list(range(len(order)))
    got = []
    for _, name in order:
        ti, wm, tv, wn, _, blocks, _, eff = map(int, re.search(
            rf"using {name} = DualTile<([^>]*)>;", src).group(1).split(","))
        got.append((4 * ti * wm, 8 * tv * wn, blocks, eff))
    return tuple(got)


@pytest.mark.parametrize("views", [12, 18])
def test_dual_tile_mirror_and_projection_checks_reach_both_tiles(views):
    """``chip_smoke.dual_tile`` restates csrc/f32_tile.cuh's dual tiles
    (rows, value columns, blocks an SM, rate; the cheapest by whole waves,
    the lowest number at a tie); the fp32 kv and out projections at the
    224x400 and 272x736 paths' grids over ``views`` (the request's 12, the
    B=3 step's 18) reach the tiles as the busiest SM's rounds say
    (``sm_rounds``; DualBroad where DualWide's leave SMs a block short: the
    out-projection at 12 x 350 rows takes 33 x 8 blocks, two on every SM),
    and every tile on one of them; ``check_projection_tiles`` gates each
    projection on every tile (KV_PROJECTION_TILES, OUT_PROJECTION_TILES,
    rows ragged against every tile) and one input bitwise on every tile
    (PROJECTION_BITWISE, ``tile_rows``); ``dual_rates``' grids are whole
    rounds of the tile they time on every SM, which ``dual_tile`` takes
    there."""
    import chip_smoke

    tiles = chip_smoke.DUAL_TILES
    assert _dual_tiles() == tiles
    assert "return sm_rounds(blocks, sms, G::MIN_BLOCKS) * G::BM * G::BN " \
        "* 100.0 /" in (build.CSRC / "f32_tile.cuh").read_text()
    for M, N in ((4200, 320), (16800, 160), (6300, 320), (9384, 320),
                 (100, 5), (25200, 320)):
        costs = [chip_smoke.sm_rounds(-(-M // bm) * -(-N // bn), 132, b) *
                 bm * bn * 100.0 / e for bm, bn, b, e in tiles]
        assert chip_smoke.dual_tile(M, N) == costs.index(min(costs))
    outs = {(L, C) for _, L, _, C, _, _ in chip_smoke._path_attentions()}
    got_out = {(L, C): chip_smoke.dual_tile(views * L, C // 2)
               for L, C in outs | {(782, 640)}}
    got_kv = {chip_smoke.dual_tile(views * Lk, C)
              for _, _, Lk, C, _, _ in chip_smoke._path_attentions()}
    if views == 12:
        assert got_out == {(1400, 320): 0, (350, 640): 3, (782, 640): 0}
        assert got_kv == {0, 1, 2, 3}
    else:
        assert got_out == {(1400, 320): 3, (350, 640): 0, (782, 640): 0}
        assert got_kv == {0, 2}
    assert [chip_smoke.dual_tile(B * Lk, H * D) for B, Lk, _, H, D in
            chip_smoke.KV_PROJECTION_TILES] == list(range(len(tiles)))
    assert [chip_smoke.dual_tile(M, N // 2) for M, _, N in
            chip_smoke.OUT_PROJECTION_TILES] == list(range(len(tiles)))
    for t, M, N in [(t, B * Lk, H * D) for t, (B, Lk, _, H, D) in
                    enumerate(chip_smoke.KV_PROJECTION_TILES)] + \
            [(t, M, N // 2) for t, (M, _, N) in
             enumerate(chip_smoke.OUT_PROJECTION_TILES)]:
        assert all(M % bm for bm, *_ in tiles) and N % tiles[t][1]
    assert all(N % 8 == 0 and K % 8 == 0
               for _, K, N in chip_smoke.OUT_PROJECTION_TILES)
    assert all(B == 2 and Lk % tiles[t][0] for t, (B, Lk, *_) in
               enumerate(chip_smoke.KV_PROJECTION_TILES))
    M0, K, N = chip_smoke.PROJECTION_BITWISE
    rows = chip_smoke.tile_rows(M0, N // 2)
    assert sorted(rows) == list(range(len(tiles)))
    assert min(rows.values()) == M0
    for t, (M, N2) in enumerate(chip_smoke.DUAL_RATE_GRIDS):
        bm, bn, b, _ = tiles[t]
        assert chip_smoke.dual_tile(M, N2) == t
        assert M % bm == 0 and N2 % bn == 0
        assert (M // bm) * (N2 // bn) % (132 * b) == 0


def test_ff_training_shapes_are_the_fp32_steps():
    """``chip_smoke.FF_SHAPES``, where K3's and K4's fp32 instances are
    also gated and timed over TRAIN_VIEWS (and beside their parent by
    ``compare_trees``), are the (kernel, L, C) of every transformer of the
    224x400 model at the element size 4 (K3 where ``ff_full_fusion_fits``
    holds); TRAIN_VIEWS is the fp32 CLI's B=3 of 6 views."""
    import chip_smoke
    from magicdrive_tpu_torch.config import sd15mv_rawbox_224x400

    full = sd15mv_rawbox_224x400()
    got = {("fused_ff" if dispatch.ff_full_fusion_fits(C, 4 * C, C, 4)
            else "fused_geglu", L, C)
           for _, _, L, C, _ in chip_smoke._transformers(full)}
    assert got == set(chip_smoke.FF_SHAPES)
    assert "runner.train_batch_size=3" in chip_smoke.F32_CLI_ARGS
    assert chip_smoke.TRAIN_VIEWS == 3 * len(full.unet.neighboring_view_pair)


# ---------------------------------------------------------------------------
# the wrappers' dtype rules, with the library and the card stood in for
# ---------------------------------------------------------------------------

class _Lib:
    """A kernel library that records the C entries called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mdk_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            return 0
        entry.__name__ = name
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors stand for the card's: the wrappers take the launch
    branch, check their inputs and call the recording library."""
    lib = _Lib()
    monkeypatch.setattr(dispatch, "_on_cpu", lambda x: False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(dispatch, "_stream", lambda: 0)
    monkeypatch.setattr(dispatch, "_ptr", lambda t: None)
    monkeypatch.setattr(dispatch, "check_table", lambda *a: None)
    monkeypatch.setattr(build, "load", lambda: lib)
    return lib


def _calls(dt):
    """Each wrapper's call on meta tensors of ``dt`` -> (wrapper, call)."""
    z = lambda *s, d=dt: torch.zeros(*s, dtype=d, device="meta")
    x, w = z(6, 40, 16), z(16, 16)
    table = torch.zeros(2, 6, dtype=torch.int32, device="meta")
    q, lse = z(4, 24, 16), z(4, 24, d=torch.float32)
    return {
        "kvstat_attention": lambda: dispatch.kvstat_attention(
            x, x, w, w, w, 2, 0.3),
        "kvstat_attention_pair": lambda: dispatch.kvstat_attention_pair(
            x, w, w, w, 2, 0.3, table),
        "fused_qkv_attention": lambda: dispatch.fused_qkv_attention(
            x, x, w, w, w, 2, 0.3),
        "fused_qkv_out_attention": lambda: dispatch.fused_qkv_out_attention(
            x, x, w, w, w, w, 2, 0.3),
        "fused_qkv_out_attention_pair":
            lambda: dispatch.fused_qkv_out_attention_pair(
                x, w, w, w, w, 2, 0.3, table),
        "fused_geglu": lambda: dispatch.fused_geglu(x, z(32, 16), z(32)),
        "fused_ff": lambda: dispatch.fused_ff(x, z(32, 16), z(32),
                                              z(16, 16)),
        "flash_attention_fwd": lambda: dispatch.flash_attention_fwd(q, q, q),
        "flash_attention_bwd": lambda: dispatch.flash_attention_bwd(
            q, q, q, q, lse, q),
    }


# the C entries each wrapper launches, in order
_ENTRIES = {
    "kvstat_attention": ["mdk_kv_project", "mdk_kvstat_attention"],
    "kvstat_attention_pair": ["mdk_kv_project", "mdk_kvstat_attention_pair"],
    "fused_qkv_attention": ["mdk_kv_project", "mdk_kvstat_attention"],
    "fused_qkv_out_attention": ["mdk_kv_project", "mdk_kvstat_attention",
                                "mdk_out_project"],
    "fused_qkv_out_attention_pair": ["mdk_kv_project",
                                     "mdk_kvstat_attention_pair",
                                     "mdk_out_project"],
    "fused_geglu": ["mdk_geglu"],
    "fused_ff": ["mdk_ff"],
    "flash_attention_fwd": ["mdk_flash_fwd"],
    "flash_attention_bwd": ["mdk_flash_bwd_dq", "mdk_flash_bwd_dkv"],
}


@pytest.mark.parametrize("dt,suffix", [(torch.bfloat16, ""),
                                       (torch.float32, "_f32")])
def test_wrappers_launch_the_entry_of_their_dtype(fake_card, dt, suffix):
    """A call whose floating tensors are all bf16 launches the bf16
    entries, one whose tensors are all fp32 the ``_f32`` ones, and each
    counts its launch under the kernel's one name."""
    dispatch.reset_launches()
    for name, call in _calls(dt).items():
        fake_card.calls.clear()
        call()
        assert fake_card.calls == [e + suffix for e in _ENTRIES[name]], name
    counted = {k: v for k, v in dispatch.LAUNCHES.items() if v}
    dispatch.reset_launches()
    assert counted == {**dict.fromkeys(
        ("kvstat_attention", "kvstat_attention_pair", "fused_qkv_attention",
         "fused_qkv_out_attention", "fused_qkv_out_attention_pair",
         "fused_geglu", "fused_ff", "flash_attention_fwd",
         "flash_attention_bwd_dq", "flash_attention_bwd_dkv"), 1)}


def test_mixed_or_other_dtypes_raise(fake_card):
    """bf16 beside fp32, or any other float type, raises before a launch:
    there is no kernel for it and no fallback."""
    z = lambda *s, d: torch.zeros(*s, dtype=d, device="meta")
    x32, w16 = z(6, 40, 16, d=torch.float32), z(16, 16, d=torch.bfloat16)
    with pytest.raises(ValueError, match="all bf16 or all fp32"):
        dispatch.kvstat_attention(x32, x32, w16, w16, w16, 2, 0.3)
    x16 = z(6, 40, 16, d=torch.float16)
    w = z(16, 16, d=torch.float16)
    with pytest.raises(ValueError, match="all bf16 or all fp32"):
        dispatch.kvstat_attention(x16, x16, w, w, w, 2, 0.3)
    q = z(4, 24, 16, d=torch.float32)
    with pytest.raises(ValueError, match="all bf16 or all fp32"):
        dispatch.flash_attention_fwd(q, q, q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="all bf16 or all fp32"):
        dispatch.fused_geglu(x32, z(32, 16, d=torch.float32),
                             z(32, d=torch.bfloat16))
    assert fake_card.calls == []
    assert dispatch._check("f", x32, None, x32) == "_f32"


# ---------------------------------------------------------------------------
# the plain versions at fp32 against the Pallas kernels at fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", DEPTHS)
def test_k1_plain_matches_pallas_fp32(D):
    rs = np.random.RandomState(20 + D)
    B, Lq, Lk, C, Ck, H = 2, 40, 24, 48, 32, 2
    xq = rs.randn(B, Lq, C).astype(np.float32)
    xkv = rs.randn(B, Lk, Ck).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_weights(rs, c, H, D)
                                    for c in (C, Ck, Ck))
    want = jfa.fused_kvstat_attention(jnp.asarray(xq), jnp.asarray(xkv), jq,
                                      jk, jv, heads=H, scale=D ** -0.5,
                                      interpret=True)
    assert want.dtype == jnp.float32
    got = reference.kvstat_attention(_t(xq), _t(xkv), tq, tk, tv, H,
                                     D ** -0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _unpad(want, B, Lq, H, D),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D", DEPTHS)
def test_k2_plain_matches_pallas_fp32(D):
    """The pair over a neighbour table that is not a permutation, against
    the Pallas pair on the views the same lists gather."""
    rs = np.random.RandomState(30 + D)
    n, L, C, H = 6, 24, 32, 2
    x = rs.randn(n, L, C).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_weights(rs, C, H, D) for _ in range(3))
    xj = jnp.asarray(x)
    name = "not_a_permutation"
    want = jfa.fused_kvstat_attention_pair(
        xj, gathered(xj, name, 0), gathered(xj, name, 1), jq, jk, jv,
        heads=H, scale=D ** -0.5, interpret=True, shifts=None)
    got = reference.kvstat_attention_pair(_t(x), tq, tk, tv, H, D ** -0.5,
                                          table_of(name))
    np.testing.assert_allclose(got.numpy(), _unpad(want, n, L, H, D),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("C", DEPTHS)
def test_k3_k4_plain_match_pallas_fp32(C):
    """K3 (in C, inner 4C, out C) and K4 at the widths 40, 80 and 128,
    with the W1 bias."""
    rs = np.random.RandomState(40 + C)
    x = rs.randn(2, 19, C).astype(np.float32)
    (k1, b1, k2), (w1, tb1, w2) = _ff_weights(rs, C, 4 * C, C)
    want = jgg.fused_ff(jnp.asarray(x), k1, b1, k2, interpret=True)
    np.testing.assert_allclose(
        reference.fused_ff(_t(x), w1, tb1, w2).numpy(), np.asarray(want),
        atol=ATOL, rtol=RTOL)
    want = jgg.fused_geglu(jnp.asarray(x), k1, b1, interpret=True)
    np.testing.assert_allclose(
        reference.fused_geglu(_t(x), w1, tb1).numpy(), np.asarray(want),
        atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("D", DEPTHS)
def test_k5_k6_plain_match_pallas_fp32(D, monkeypatch):
    """K5 (o and lse) and K6 (dq, dk, dv) with keys masked past kv_len,
    several q and k blocks in the Pallas kernels."""
    monkeypatch.setattr(jfl, "_auto_blocks_bwd", lambda *a: (16, 32))
    rs = np.random.RandomState(50 + D)
    BH, Lq, Lk, kv_len = 2, 40, 72, 61
    q, k, v = _flash_inputs(rs, BH, Lq, Lk, D)
    do = rs.randn(BH, Lq, D).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o, lse = jfl._flash_fwd(jq, jk, jv, 1.0, kv_len, 16, 32, True,
                            with_lse=True)
    got_o, got_lse = reference.flash_attention_fwd(_t(q), _t(k), _t(v),
                                                   kv_len)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                               atol=ATOL, rtol=RTOL)
    want = jfl._flash_bwd(jq, jk, jv, o, lse, jnp.asarray(do), 1.0, kv_len,
                          16, 32, True)
    got = reference.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(np.asarray(o)), _t(np.asarray(lse)[..., 0]),
        _t(do), kv_len)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


# ---------------------------------------------------------------------------
# the launches of an fp32 step of the 224x400 routing
# ---------------------------------------------------------------------------

# tiny widths standing for the 224x400 preset's, one per level and one for
# the text context, so that the routing rules see the full-width shapes
_WIDTHS = {8: 320, 24: 640, 40: 1280, 16: 768}


def _full_width(monkeypatch):
    """``dispatch``'s routing rules, which the modules look up when they
    run, answering for the 224x400 widths of the tiny widths (_WIDTHS;
    the head depth scales with the width, 8 heads a level there)."""
    rules = {n: getattr(dispatch, n) for n in (
        "attention_route", "pair_route", "ff_full_fusion_fits")}
    # full widths pass unchanged: the rules call each other
    c = lambda w: _WIDTHS.get(w, w)
    d = lambda dh: _WIDTHS[dh * 2] // 8 if dh * 2 in _WIDTHS else dh
    monkeypatch.setattr(dispatch, "attention_route",
                        lambda Lq, Lk, C, D, e: rules["attention_route"](
                            Lq, Lk, c(C), d(D), e))
    monkeypatch.setattr(dispatch, "pair_route",
                        lambda L, C, D, e, k=2: rules["pair_route"](
                            L, c(C), d(D), e, k))
    monkeypatch.setattr(dispatch, "ff_full_fusion_fits",
                        lambda K, N, C, e=2: rules["ff_full_fusion_fits"](
                            c(K), 4 * c(K), c(C), e))


@pytest.mark.parametrize("mode", ["kvstat", "auto"])
def test_fp32_step_launches_match_derived_224x400(mode, monkeypatch):
    """A counted fp32 train step of a model with the 224x400 block
    structure, context and routing (tiny widths answered for by the full
    widths' rules) launches what ``expected_launches`` derives for the
    224x400 preset at esize 4: under "auto" attn4 at L=1400 takes the
    per-neighbour K8 loop (two K8 calls a forward) and the pair only at
    L=350; K3 takes level 0's FF alone."""
    import chip_smoke
    from magicdrive_tpu_torch.config import (sd15mv_rawbox_224x400,
                                             tiny_debug)
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_sample)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import (TrainConfig, create_train_state,
                                            train_step)

    full = sd15mv_rawbox_224x400()
    want = chip_smoke.expected_launches(full, mode, steps=1, esize=4)
    with dispatch.fused_mode(mode):
        assert dispatch.pair_route(1400, 320, 40, 4) == (
            "out_loop" if mode == "auto" else "kvstat")
        assert dispatch.pair_route(1400, 320, 40, 2) in ("kvstat", "out")
    base = tiny_debug()
    unet = dataclasses.replace(base.unet, block_out_channels=(8, 24, 40, 40))
    preset = dataclasses.replace(
        base, unet=unet, bbox_max_len=full.bbox_max_len,
        controlnet=dataclasses.replace(base.controlnet, unet=dataclasses.
                                       replace(unet,
                                               neighboring_view_pair=None)))
    _full_width(monkeypatch)
    torch.manual_seed(0)
    modules = MagicDriveModules.create(preset, device="cpu")
    cfg = TrainConfig(lr_warmup_steps=1)
    state = create_train_state(modules, cfg, device="cpu",
                               dtype=torch.float32)
    batch = collate_fn([make_sample(0, with_images=True)],
                       CollateConfig(bbox_max_len=preset.bbox_max_len))
    names = set(chip_smoke.training_calls("kvstat")) | \
        set(chip_smoke.training_calls("auto"))
    with chip_smoke.counted_calls(names) as calls, dispatch.fused_mode(mode):
        train_step(modules, state, batch, cfg,
                   generator=torch.Generator().manual_seed(0))
    bwd = calls.pop("flash_attention_bwd")
    got = {**dict.fromkeys(dispatch.LAUNCHES, 0), **calls,
           "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkv": bwd}
    assert got == want
    assert want["fused_ff"] == 7 and want["fused_geglu"] == 16
    if mode == "auto":
        # attn1 and attn2 of every level-0/1 transformer and attn4's two
        # per-neighbour calls at level 0 (5 UNet transformers), the pair at
        # level 1 (5)
        assert want["fused_qkv_out_attention"] == 31
        assert want["fused_qkv_out_attention_pair"] == 5
