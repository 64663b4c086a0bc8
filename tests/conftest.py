"""Test harness: run everything on a virtual 8-device CPU mesh.

This is the standard JAX substitute for multi-chip hardware (SURVEY §4).
A pytest plugin imports jax before this conftest runs, so env vars alone are
too late — use jax.config.update, which still works before any backend is
initialized.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses we spawn

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips without one (on the card: "
        "python -m pytest -m gpu tests/)",
    )
