"""rtbench: the benchmark of the PyTorch/CUDA path tracer ``rt_tpu_torch``.

``run.py`` runs one cell; ``harness`` drives it, ``drivers`` and the scene
generators' program sides (``scenes/``) are the only modules that import the
program, ``check``, ``reference`` and the generators' reference sides
(``inputs/``) decide ``correct`` without it, ``stats`` and ``trace`` hold
the arithmetic.
"""
