"""The program's entries a cell can drive: ``decode``, ``prefill``. Each
module's ``run(bench)`` sets up, measures the window, and checks the
answers against the plain reference."""
