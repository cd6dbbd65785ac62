"""The comparison that decides ``correct``, shown to fail: the fp8 control
against the program's bfloat16 path, and runs with the timed path broken
underneath (a token or an answer altered where it is produced, a step that
returns its state unchanged, a page placed in both tiers, half of a
training batch left out), each driving the rest of a run on the CPU at
small sizes."""
import numpy as np
import pytest
import torch

from portbench import check, smoke

SEEDS = (1, 2, 3)


@pytest.mark.parametrize("name,number", [
    ("zamba2-decode-tiered", "served_gap"),
    ("zamba2-prefill-4k", "last_logit_rel_err"),
    ("zamba2-train-4k", "grad_norm_gap")])
def test_control_fails(name, number):
    runs = [smoke.run(name, s, control=True) for s in SEEDS]
    program = [r.compared[number][0] for r in runs]
    control = [r.record[f"control_{number}"] for r in runs]
    assert all(r.correct for r in runs)
    assert min(control) >= 3 * max(program)
    cell, _ = smoke.smoke_cell(name)
    assert min(control) > cell["limits"][number]


def wrap_serve(monkeypatch, fault):
    import repro_torch.serve.decode as D
    build = D.build_serve_step

    def broken(*a, **k):
        step = build(*a, **k)
        calls = [0]

        def serve_step(model, state, tokens):
            calls[0] += 1
            return fault(step, model, state, tokens, calls[0])
        return serve_step
    monkeypatch.setattr(D, "build_serve_step", broken)


def token_altered(step, model, state, tokens, n):
    logits, new = step(model, state, tokens)
    if n == 10:                          # every sequence's token, one step
        rows = torch.arange(logits.shape[0])
        top = logits[:, -1].argmax(-1)
        logits = logits.clone()
        logits[rows, -1, (top + 1) % logits.shape[-1]] = \
            logits[rows, -1, top] + 1
    return logits, new


def state_unchanged(step, model, state, tokens, n):
    logits, _ = step(model, state, tokens)
    return logits, state


def page_in_both_tiers(step, model, state, tokens, n):
    logits, new = step(model, state, tokens)
    kv = new["kv"]
    if n == 20:
        free = int((kv.slow_page[0] < 0).nonzero()[0])
        held = int(kv.fast_page[0][kv.fast_page[0] >= 0][0])
        kv.slow_page[0, free] = held
    return logits, new


@pytest.mark.parametrize("fault", [token_altered, state_unchanged,
                                   page_in_both_tiers])
def test_decode_faults_fail(monkeypatch, fault):
    wrap_serve(monkeypatch, fault)
    assert not smoke.run("zamba2-decode-tiered", 1).correct


@pytest.mark.parametrize("name", ["zamba2-prefill-4k"])
def test_prefill_answer_altered_fails(monkeypatch, name):
    import repro_torch.train.step as T
    build = T.make_prefill_step

    def broken(*a, **k):
        step = build(*a, **k)

        def prefill_step(model, batch):
            out = step(model, batch)
            return out + 0.1 * out.abs().max() * torch.randn_like(out)
        return prefill_step
    monkeypatch.setattr(T, "make_prefill_step", broken)
    assert not smoke.run(name, 1).correct


def test_tiering_violations_by_hand():
    # 2 sequences, 4 logical pages of 2 tokens; 3 tokens written each
    snap = {"fast_page": np.array([[0, -1], [1, -1]]),
            "slow_page": np.array([[1, -1], [0, -1]]),
            "page_tier": np.array([[0, 1, -1, -1], [1, 0, -1, -1]]),
            "page_idx": np.array([[0, 0, 0, 0], [0, 0, 0, 0]]),
            "seq_len": np.array([3, 3]), "tenant": np.array([0, 1])}
    ok = check.tiering_violations(snap, budget=2, bounds=[0, 1],
                                  page_tokens=2)
    assert ok == {"pages_not_in_one_tier": 0, "fast_pages_over_budget": 0,
                  "fast_pages_over_bounds": 0}
    snap["slow_page"][0, 1] = 0                  # page 0 in both tiers
    snap["fast_page"][1, 1] = 5                  # a third fast page
    bad = check.tiering_violations(snap, budget=2, bounds=[0, 1],
                                   page_tokens=2)
    assert bad == {"pages_not_in_one_tier": 1, "fast_pages_over_budget": 1,
                   "fast_pages_over_bounds": 1}


def test_served_gap_and_rel_err():
    ref = torch.tensor([[1.0, 3.0, 2.0], [0.0, -1.0, 0.5]])
    assert check.served_gap(ref, torch.tensor([1, 2])) == 0.0
    assert check.served_gap(ref, torch.tensor([2, 1])) == 1.5
    assert check.logit_rel_err(ref + 0.3, ref) == pytest.approx(0.1)


def wrap_train(monkeypatch, fault):
    import repro_torch.train.step as T
    build = T.make_train_step

    def broken(*a, **k):
        step = build(*a, **k)
        return lambda model, opt, batch: fault(step, model, opt, batch)
    monkeypatch.setattr(T, "make_train_step", broken)


def train_state_unchanged(step, model, opt, batch):
    saved = [p.detach().clone() for p in model.parameters()]
    _, metrics = step(model, opt, batch)
    with torch.no_grad():
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return opt, metrics


def half_batch(step, model, opt, batch):
    rows = batch["tokens"].shape[0] // 2
    return step(model, opt, {k: v[:rows] for k, v in batch.items()})


@pytest.mark.parametrize("fault", [train_state_unchanged, half_batch])
def test_train_faults_fail(monkeypatch, fault):
    wrap_train(monkeypatch, fault)
    run = smoke.run("zamba2-train-4k", 1)
    assert not run.correct
    if fault is train_state_unchanged:
        assert run.compared["update_norm_gap"][0] == pytest.approx(1.0)
