"""The port's examples and the served entry point at the reduced configs.

``examples/torch_serve_lm.py`` and ``examples/torch_train_lm.py`` (the
counterparts of ``examples/serve_lm.py`` and ``examples/train_lm.py``) run
on the CPU with the kernels' plain versions: the serve example's batched
decoding equals solo decoding, the train example's loss falls. Without a
GPU and without ``--device cpu`` each raises. Tests marked ``cuda`` run
``launch.serve --reduced`` (head_dim 16) on the card through the kernels,
its fp32 greedy tokens against the CPU's, and both examples there:
``python -m pytest -m cuda tests/test_torch_examples.py``. This file
imports no JAX, so it runs on the card's machine as it is.
"""

import ast
import re
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(ROOT))
from chip_smoke import load_example  # noqa: E402


@pytest.mark.parametrize("name", ["torch_serve_lm", "torch_train_lm"])
def test_examples_import_neither_jax_nor_the_reference(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}


def test_serve_example_batched_equals_solo_on_cpu(capsys):
    done = load_example("torch_serve_lm").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(r.uid for r in done) == list(range(10))
    assert all(len(r.out_tokens) == 12 for r in done)
    assert "served 10 requests / 120 tokens" in out and "on cpu" in out
    assert "batched == solo decode: OK" in out


def test_train_example_loss_falls_on_cpu(capsys):
    summary = load_example("torch_train_lm").main(
        ["--device", "cpu", "--steps", "40", "--seq-len", "64"])
    out = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"^step=\d+ .* loss=([\d.]+)", out,
                                           re.M)]
    assert summary["final_step"] == 40 and len(losses) == 2
    assert losses[1] < losses[0]
    assert summary["final_loss"] == pytest.approx(losses[1], rel=1e-4)
    assert "training smollm-135m-reduced" in out and "on cpu" in out


@pytest.mark.parametrize("name", ["torch_serve_lm", "torch_train_lm"])
def test_examples_without_gpu_raise(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_example(name).main([])


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# The kernels a reduced model's serving launches: attention in every
# attention layer (zamba2's shared block), RMSNorm in every layer, the SSD
# scan in every mamba layer of a prefill.
SERVED_KERNELS = {"smollm-135m": ("flash_attention", "rmsnorm"),
                  "mamba2-780m": ("rmsnorm", "ssd_scan")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(SERVED_KERNELS))
def test_launch_serve_reduced_on_cuda(cuda_device, arch, dtype):
    """``launch.serve --reduced`` on the card (head_dim 16 on every
    attention route): every request answered through the kernels; in
    fp32 the greedy tokens those of the same command with ``--device
    cpu``."""
    argv = ["--arch", arch, "--reduced", "--dtype", dtype]
    before = {k: getattr(ops, k).launches for k in SERVED_KERNELS[arch]}
    got = launch_serve.main(argv)
    assert len(got["requests"]) == 8 and got["tokens"] == 128
    for k, n in before.items():
        assert getattr(ops, k).launches > n, k
    if dtype == "float32":
        want = launch_serve.main(argv + ["--device", "cpu"])
        assert ([r.out_tokens for r in got["requests"]]
                == [r.out_tokens for r in want["requests"]])


@pytest.mark.cuda
def test_examples_on_cuda(cuda_device, capsys):
    """Both examples on the card: batched decoding equals solo decoding
    there too, and the train example's loss falls below its bound."""
    load_example("torch_serve_lm").main([])
    summary = load_example("torch_train_lm").main(["--steps", "100"])
    out = capsys.readouterr().out
    assert "batched == solo decode: OK" in out and "on cuda" in out
    assert summary["final_step"] == 100 and summary["final_loss"] < 7.0
