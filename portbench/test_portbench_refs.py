"""The plain references against the program's plain path (``impl="ref"``)
at small sizes on the CPU, in float32: the hybrid and dense forwards, the
hybrid decode through the tiered cache against the forward, and AdamW."""
import pytest
import torch

from portbench import harness, model, smoke, traffic
from portbench.refs import adamw as ref_adamw
from portbench.refs import dense as ref_dense
from portbench.refs import hybrid as ref_hybrid


CONFS = {"zamba2-7b-d24": lambda: harness.load_json(
    harness.BENCH / "configs" / "zamba2-7b-d24.json"),
    "dense-smoke": lambda: smoke.DENSE}


def build(conf_name: str, seed: int = 3):
    conf = smoke.smoke_conf(CONFS[conf_name]())
    conf["port"]["dtype"] = "float32"
    cfg = model.model_config(conf)
    return conf, cfg, model.build(conf, cfg, seed, "cpu")


@pytest.mark.parametrize("conf_name,ref", [("zamba2-7b-d24", ref_hybrid),
                                           ("dense-smoke", ref_dense)])
def test_forward_matches_program(conf_name, ref):
    from repro_torch.models.transformer import model_forward
    conf, cfg, m = build(conf_name)
    toks = traffic.tokens(5, "t", 0, (2, 48), cfg.vocab_size, "cpu")
    with torch.no_grad():
        want = model_forward(m, {"tokens": toks}, impl="ref")
    got = ref.forward(m.tree(), conf["port"], toks)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max())
    last = ref.forward(m.tree(), conf["port"], toks, last_only=True)
    assert torch.allclose(last[:, 0], got[:, -1], rtol=1e-5, atol=1e-5)


def test_hybrid_decode_matches_forward():
    """The program's tiered decode, step by step, equals the reference's
    forward over the same tokens (the decode cell's check in float32)."""
    from portbench.paths.decode import tiering_config
    from repro_torch.serve.decode import build_serve_step, init_serve_state
    conf, cfg, m = build("zamba2-7b-d24")
    cell, _ = smoke.smoke_cell("zamba2-decode-tiered")
    tr = cell["traffic"]
    tcfg = tiering_config(tr)
    B, H = tr["batch"], tr["decode_tokens"]
    step = build_serve_step(cfg, tcfg, B, H, device="cpu")
    state = init_serve_state(cfg, tcfg, B, H, device="cpu")
    toks = traffic.tokens(9, "t", 0, (B, H), cfg.vocab_size, "cpu")
    got = []
    for i in range(H):
        logits, state = step(m, state, toks[:, i:i + 1])
        got.append(logits[:, -1])
    assert int((state["kv"].counters.promotions
                + state["kv"].counters.demotions).sum()) > 0
    want = ref_hybrid.forward(m.tree(), conf["port"], toks)
    got = torch.stack(got, dim=1)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max())


def test_adamw_matches_program():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim.adamw import adamw_update, init_opt_state
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6)
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 3, generator=g),
              "b": torch.randn(7, generator=g)}
    mine = {k: v.clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    opt = init_opt_state(params)
    for t in range(1, 6):
        grads = {k: torch.randn(p.shape, generator=g) * (3.0 if t == 2 else
                                                         0.1)
                 for k, p in params.items()}
        _, opt, metrics = adamw_update(params, grads, opt, tc)
        norm = ref_adamw.step(
            mine, grads, m, v, t, lr=tc.learning_rate, warmup=tc.warmup_steps,
            total=tc.total_steps, beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
            weight_decay=tc.weight_decay, clip=tc.grad_clip)
        assert norm == pytest.approx(float(metrics["grad_norm"]), rel=1e-5)
        for k in params:
            assert torch.allclose(mine[k], params[k], rtol=1e-5, atol=1e-6)


def test_fp8_control_rounds_weight_products():
    """The control's products lie farther from float32 than bfloat16's."""
    from portbench.refs import common as C
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(64, 128, generator=g), torch.randn(128, 32, generator=g)
    exact = C.mm(x, w)
    bf16 = (x.bfloat16().float() @ w.bfloat16().float())
    low = C.mm(x, w, mode="fp8")
    assert (low - exact).abs().max() > 4 * (bf16 - exact).abs().max()
    with pytest.raises(ValueError):
        C.mm(x, w, mode="int3")
