"""The port end to end, on the CPU.

- The port CLI (``--device cpu -c 1 --cudaaligner-batches 1``: both device
  engines on their plain PyTorch kernels) writes FASTA **byte-identical**
  to the JAX CLI's ``-c 1 --tpualigner-batches 1`` on a simulated
  0.02 Mbp genome (seed 11). Both CLIs run concurrently; the JAX one takes
  most of the wall time.
- The port and ``chip_smoke.py`` import neither ``jax`` nor ``racon_tpu``.
- A default-device (``cuda``) entry point raises on a host without a card.
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def sim_inputs(tmp_path_factory):
    from racon_tpu_torch.utils.simulate import write_inputs
    return write_inputs(0.02, str(tmp_path_factory.mktemp("sim")), seed=11)


def _cli(module, args, extra_env=None):
    env = dict(os.environ)
    env.update(extra_env or {})
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def test_port_cli_matches_jax_cli(sim_inputs):
    inputs = [sim_inputs["reads"], sim_inputs["overlaps"],
              sim_inputs["draft"]]
    jax_proc = _cli("racon_tpu",
                    ["-t", "2", "-c", "1", "--tpualigner-batches", "1",
                     *inputs],
                    {"JAX_PLATFORMS": "cpu", "XLA_FLAGS":
                     "--xla_force_host_platform_device_count=1"})
    port_proc = _cli("racon_tpu_torch",
                     ["-t", "2", "-c", "1", "--cudaaligner-batches", "1",
                      "--device", "cpu", *inputs], {"OMP_NUM_THREADS": "4"})
    port_out, port_err = port_proc.communicate(timeout=900)
    jax_out, jax_err = jax_proc.communicate(timeout=900)
    assert port_proc.returncode == 0, port_err.decode()[-2000:]
    assert jax_proc.returncode == 0, jax_err.decode()[-2000:]
    assert port_out.startswith(b">contig_0 LN:i:")
    assert port_out == jax_out


_ISOLATION = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "racon_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import racon_tpu_torch
for mod in pkgutil.walk_packages(racon_tpu_torch.__path__,
                                 "racon_tpu_torch."):
    if not mod.name.endswith("__main__"):
        importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "racon_tpu"))
print("LOADED", bad)
"""


def test_port_and_smoke_import_neither_jax_nor_racon_tpu():
    """Every module of the package, and chip_smoke.py, import with jax
    and racon_tpu blocked, and none of them is loaded afterwards."""
    proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def test_default_device_raises_without_a_card(sim_inputs):
    """The entry points run on cuda unless asked for cpu: with no card
    they raise instead of continuing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from racon_tpu_torch.core.polisher import create_polisher
    from racon_tpu_torch.ops.nw import CudaAligner
    from racon_tpu_torch.ops.poa import CudaPoaConsensus
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaAligner()
    with pytest.raises(RuntimeError, match="CUDA"):
        CudaPoaConsensus(3, -5, -4)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_polisher(sim_inputs["reads"], sim_inputs["overlaps"],
                        sim_inputs["draft"], aligner="cuda",
                        consensus="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch", "-c", "1",
         sim_inputs["reads"], sim_inputs["overlaps"], sim_inputs["draft"]],
        cwd=REPO, capture_output=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == b""
    assert b"torch.cuda.is_available() is False" in proc.stderr
