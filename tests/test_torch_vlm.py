"""The vlm family (Llama 3.2 Vision) of the port held against the JAX
reference on the CPU, through ``test_torch_encdec.py``'s harness: the smoke
config (4 layers: two units of one self block and one gated cross block,
8 image tokens) in float32, the gates opened to U[0.5, 1.0] before the
reference's tree crosses over, the reference jitted. Bounds as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import TieringConfig as JCfg
from repro.models import transformer as JTF
from repro.serve import decode as JSD
from repro_torch.configs import get_config, reduced_depth_config
from repro_torch.configs.base import TieringConfig as TCfg
from repro_torch.memtier import kvcache as TKC
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TF
from repro_torch.serve.decode import init_serve_state
from test_torch_configs import MODES
from test_torch_encdec import (CROSS_KV_ATOL, DECODE_ATOL, FWD_RTOL, T_,
                               cli_runs, decode_matches_forward,
                               encoder_input, forward_matches_reference,
                               opened, params_match_reference,
                               port_cross_kv, prefill_matches_reference,
                               reference_cross_kv, rel,
                               serve_matches_reference, zeroed_decode_moves)

ARCH = "llama32_vision_90b"


def test_vlm_params_and_counts_match_reference():
    """``units.self`` [n_units, every - 1, ...], the scalar gates
    [n_units]; at depth 10 two units of 4 self and 1 cross layer, 8 KV
    layers."""
    params_match_reference(ARCH)
    _, model, cfg_j, _ = opened(ARCH)
    every = cfg_j.cross_attn_every
    units = cfg_j.num_layers // every
    assert model.units["self"]["attn"]["wq"].shape[:2] == (units, every - 1)
    assert model.units["cross"]["gate"].shape == (units,)
    assert float(model.units["cross"]["gate"].min()) >= 0.5
    cfg10 = reduced_depth_config(ARCH, 10)
    assert cfg10.num_layers == 10 and TKC.kv_layer_count(cfg10) == 8
    assert TKC.kv_layer_count(get_config(ARCH)) == 80


def test_vlm_cross_block_matches_reference():
    """One gated cross block (tanh of each gate in float32, cast, then
    multiplied) over 24 text positions against 8 image tokens."""
    params, model, cfg_j, cfg_t = opened(ARCH)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 24, cfg_j.d_model)).astype(np.float32)
    enc = encoder_input(cfg_j, 2, seed=14)["image_embeds"]
    cp = jax.tree_util.tree_map(lambda a: a[1], params["units"]["cross"])
    want = jax.jit(lambda p, a, e: JTF._cross_block(p, a, e, cfg_j))(
        cp, jnp.asarray(x), jnp.asarray(enc))
    got = TF.cross_block(model.unit(1)["cross"], T_(x), cfg_t,
                         lambda p, a: TL.cross_attention(p, a, T_(enc), cfg_t))
    assert rel(got.numpy(), want) < FWD_RTOL


def test_vlm_forward_matches_reference():
    forward_matches_reference(ARCH)


def test_vlm_compute_cross_kv_matches_reference():
    """[n_units, B, n_img, K, D] straight from the image embeddings."""
    _, _, cfg_j, _ = opened(ARCH)
    extra = encoder_input(cfg_j, 3, seed=2)
    ck, cv = reference_cross_kv(ARCH, extra["image_embeds"])
    got = port_cross_kv(ARCH, extra)
    assert ck.shape == (cfg_j.num_layers // cfg_j.cross_attn_every, 3,
                        cfg_j.num_image_tokens, cfg_j.num_kv_heads,
                        cfg_j.resolved_head_dim)
    for g, w in zip(got, (ck, cv)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=CROSS_KV_ATOL)
    # the zeros of a fresh state have the reference's shapes
    want = JSD.init_serve_state(cfg_j, JCfg(n_tenants=2, page_tokens=4), 3,
                                8)
    got = init_serve_state(opened(ARCH)[3], TCfg(n_tenants=2, page_tokens=4),
                           3, 8, device="cpu")
    for k in ("cross_k", "cross_v"):
        assert tuple(got[k].shape) == want[k].shape
        assert not bool(got[k].any())


@pytest.mark.parametrize("mode", MODES)
def test_vlm_serve_step_matches_reference(mode):
    serve_matches_reference(ARCH, mode)


def test_vlm_decode_matches_forward_and_gates_matter():
    """Decode == forward with pages moving; the same decode with the cross
    K/V at zeros, or with the gates closed as well, moves the logits far
    past the bound."""
    _, _, toks, _, dec = decode_matches_forward(ARCH)
    for zero_gates in (False, True):
        assert zeroed_decode_moves(ARCH, dec, toks, zero_gates) \
            > 100 * DECODE_ATOL


def test_vlm_prefill_matches_reference():
    prefill_matches_reference(ARCH)


def test_vlm_serve_cli_runs_on_cpu(capsys):
    out = cli_runs(ARCH, capsys)
    assert "arch=llama-vision-smoke" in out
