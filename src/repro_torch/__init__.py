"""PyTorch/CUDA port of the Equilibria reproduction.

Mirrors the layout of the JAX package ``repro`` module for module; the JAX
package is the reference this port is tested against. The port imports
torch, numpy and the standard library only.

Entry points (``core.simulator.simulate``, ``core.engine.run_engine``,
``core.engine.make_tick``, ``core.simulator.simulate_preset``) run on the
card by default (``device="cuda"``) and raise when no card is present; the
CPU runs only when the caller asks for it with ``device="cpu"``.
"""
