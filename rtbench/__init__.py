"""rtbench: the benchmark of the PyTorch/CUDA path tracer ``rt_tpu_torch``.

``run.py`` runs one cell; ``harness`` drives it, ``drivers`` is the only
module that imports the program, ``check`` and ``reference`` decide
``correct`` without it, ``stats`` and ``trace`` hold the arithmetic.
"""
