"""The port's native C-ABI shim: build it with g++ into a temporary directory
and run the C smoke test (``native/test_shim.c``) against
``libgooey_tpu_torch.capi`` on the CPU (``LIBGOOEY_TPU_TORCH_DEVICE=cpu``),
with this interpreter's site-packages on the embedded one's path.  With no
card and no CPU request, ``gooey_engine_new`` returns 0 with the error
latched."""

import os
import subprocess

import pytest
import torch

from libgooey_tpu_torch.native import build as shim_build

pytestmark = pytest.mark.skipif(
    shim_build.toolchain_missing() is not None,
    reason=f"native toolchain unavailable ({shim_build.toolchain_missing()})")


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    out = shim_build.build(tmp_path_factory.mktemp("shim"))
    return out / shim_build.SMOKE_NAME


def _run(smoke, **env):
    base = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "LIBGOOEY_TPU_TORCH_DEVICE")}
    return subprocess.run([str(smoke), str(shim_build.REPO)],
                          env=shim_build.embed_env({**base, **env}),
                          capture_output=True, text=True, timeout=300)


def test_build_writes_the_library(smoke):
    assert smoke.is_file()
    assert (smoke.parent / shim_build.LIB_NAME).is_file()
    assert shim_build.DEFAULT_OUT.parts[-3:] == ("libgooey_tpu_torch", "_build", "shim")


def test_c_smoke_on_the_cpu(smoke):
    proc = _run(smoke, LIBGOOEY_TPU_TORCH_DEVICE="cpu", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("OK"), proc.stdout


def test_no_card_latches_the_error(smoke):
    """``gooey_engine_new`` gives handle 0 and the error names the missing
    card: the shim never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = _run(smoke, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 1
    assert "FAIL: engine_new" in proc.stderr and "CUDA" in proc.stderr, proc.stderr[-2000:]


def test_shim_core_imports_the_port():
    src = shim_build.SHIM_CORE.read_text()
    assert '#define GOOEY_CAPI_MODULE "libgooey_tpu_torch.capi"' in src
    assert "PyImport_ImportModule(GOOEY_CAPI_MODULE)" in src
