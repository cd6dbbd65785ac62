"""PyTorch/CUDA port of the Equilibria reproduction.

Mirrors the layout of the JAX package ``repro`` module for module; the JAX
package is the reference this port is tested against. The port imports
torch, numpy and the standard library only.

Entry points (the tick's ``core.simulator.simulate``/``simulate_preset``
and ``core.engine.run_engine``/``make_tick``; serving's
``serve.decode.build_serve_step``/``init_serve_state``, the models
``models.transformer.DenseLM``/``HybridLM``/``make_model`` and
``launch.serve``; the prefill's ``train.step.make_prefill_step``) and every
public constructor
run on the card by default (``device="cuda"``) and raise when no card is
present; the CPU runs only when the caller asks for it with
``device="cpu"``.
"""
