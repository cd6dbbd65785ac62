"""The benchmark's operation and byte counts against hand counts."""
import pytest

from portbench import harness, work
from portbench.refs import hybrid as ref_hybrid

ZAMBA = harness.load_json(harness.BENCH / "configs" / "zamba2-7b-d24.json")[
    "port"]
# a dense, windowed decoder of 24 layers at danube-4B-like widths
DENSE = dict(family="dense", num_layers=24, d_model=3840, num_heads=32,
             num_kv_heads=8, d_ff=10240, vocab_size=32000, head_dim=120,
             sliding_window=4096, act="silu")


def test_k7_bound_at_zamba2_widths():
    """K7 at Zamba2's heads (32 x 112), S=4,096, causal, bf16: 0.1216 ms,
    bound by its 4 H D S(S+1)/2 operations at 989 TFLOP/s."""
    nbytes, flops = work.k7(1, 32, 32, 112, 4096, None)
    assert flops == 4 * 32 * 112 * (4096 * 4097 // 2)
    assert nbytes == 2 * 4096 * 112 * (2 * 32 + 2 * 32)
    assert work.bound_s(nbytes, flops, work.BF16_FLOPS) * 1e3 == \
        pytest.approx(0.1216, abs=5e-5)


def test_k7_window_pairs():
    assert work.band_pairs(10, None) == 55
    assert work.band_pairs(10, 4) == 4 * 5 // 2 + 6 * 4
    assert work.band_pairs(3, 8) == 6


def test_k8_bytes_bound():
    """K8 at Zamba2's Mamba2 widths (112 heads of 64, N=64, one group),
    S=4,096: 239,599,616 bytes, 0.07152 ms at 3.35 TB/s."""
    nbytes, flops = work.k8(1, 4096, 112, 64, 64, 1, 256)
    assert nbytes == 239_599_616
    assert nbytes / work.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.07152,
                                                                abs=5e-6)
    tri = 256 * 257 // 2
    assert flops == 16 * (2 * tri * 64 + 112 * (2 * tri * 64
                                                + 4 * 256 * 64 * 64))


def test_k5_counts():
    nbytes, flops = work.k5(B=2, H=4, K=2, D=8, n_valid=10, Mf=3, Ms=5)
    assert flops == 4 * 4 * 8 * 10
    assert nbytes == 2 * 10 * 2 * 8 * 2 + 2 * 2 * 4 * 8 * 2 + 8 * 2 * 8 + 8


def test_token_macs_by_hand():
    d, di = 3584, 7168
    mamba = d * (2 * di + 2 * 2 * 64 + 112) + di * d     # 2 groups of B, C
    shared = 2 * d * d + 4 * d * 32 * 112 + 3 * d * 14336 + d * d
    assert ref_hybrid.shared_applications(ZAMBA) == 4
    assert work.family(ZAMBA).token_macs(ZAMBA) == 24 * mamba + 4 * shared
    attn = 3840 * 120 * (2 * 32 + 2 * 8)
    assert work.family(DENSE).token_macs(DENSE) == 24 * (
        attn + 3 * 3840 * 10240)


def test_model_flops():
    S = 32768
    fwd = work.forward_flops(DENSE, 1, S, 1)
    pairs = work.band_pairs(S, 4096)
    assert fwd == (2 * S * work.family(DENSE).token_macs(DENSE)
                   + 2 * 3840 * 32000 + 24 * 4 * 32 * 120 * pairs)
    step = work.decode_step_flops(ZAMBA, 256, 99)
    assert step == (2 * 256 * (ref_hybrid.token_macs(ZAMBA) + 3584 * 32000)
                    + 4 * 4 * 256 * 32 * 112 * 100
                    + 24 * 6 * 256 * 112 * 64 * 64)
    assert work.train_step_flops(ZAMBA, 2, 8) == 3 * work.forward_flops(
        ZAMBA, 2, 8, 8)
    with pytest.raises(ImportError):          # no refs/moe.py
        work.forward_flops(dict(ZAMBA, family="moe"), 1, 8, 1)
