"""COMET's analytic evaluator in the PyTorch package.

The port's copies of the JAX package's jax-free analytic modules
(``topology``, ``collectives``, ``gemm``, ``workload``, ``compiled``,
``memory``, the evaluator's part of ``cluster``), held equal to the
reference by ``tests/test_torch_core.py``, and the port of its batch
evaluator: ``torch_engine`` (the JAX package's ``jax_engine``) under the
compiled half of ``simulator``. ``simulator.time_compiled`` runs on the GPU
unless the caller asks for ``device="cpu"``. ``study.run_study`` is not
ported yet and says so.
"""
