"""The port's entry points build on the card unless the caller asks for the
CPU, and raise where there is no card; and the bounds ``chip_smoke.py``
computes for the flash kernels from a call's shapes."""
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
