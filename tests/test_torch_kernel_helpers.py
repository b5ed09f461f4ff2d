"""Host-side helpers of the port's K3 and K4 kernels, on the CPU.

* ``_build.ptxas_report`` reads registers, stack and spills from an
  ``nvcc -Xptxas -v`` log (a build's ``Built.log``): ``chip_smoke.py``
  fails when K3's warp-cell kernels spill, so the parser is held to a log
  of the form ptxas prints.
* ``chip_smoke.ssd_bound`` counts K4's products at the peak of the unit the
  model dtype can use (bf16 on the tensor cores, fp32 on the CUDA cores),
  so the bf16 bound is the byte bound at mamba2-130m's prefill shape.
* ``ssd_scan._strided_ok`` decides whether the kernel reads x, B and C in
  place: the SSM block's views into its projection are read as they are.
* ``_build.build`` keys a library on its ``-D`` macros: the clock-stamped
  copy that ``tools/kernel_probe.py`` builds (``KERNEL_PROBE``) never
  stands in for the wrappers' own build, and a header edit rebuilds both.
"""

import importlib
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels._build import ptxas_report
from repro_torch.kernels.lstm_scan import lstm_scan_layer, lstm_scan_layer_ref
from repro_torch.kernels.lstm_scan.lstm_scan import lstm_scan

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
# the module, not the function the package re-exports under its name
ssd_mod = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z5k_onev' for 'sm_90a'
ptxas info    : Function properties for _Z5k_onev
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5k_twov' for 'sm_90a'
ptxas info    : Function properties for _Z5k_twov
    16 bytes stack frame, 12 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 384 bytes cmem[0]
"""


def test_ptxas_report_reads_each_kernel():
    report = ptxas_report(LOG)
    assert [(k["registers"], k["stack_frame"], k["spill_stores"], k["spill_loads"])
            for k in report] == [(80, 0, 0, 0), (128, 16, 12, 28)]
    assert "k_one" in report[0]["kernel"] and "k_two" in report[1]["kernel"]
    assert ptxas_report("") == []


@pytest.mark.parametrize("itemsize,by", [(2, "bytes"), (4, "operations")])
def test_ssd_bound_counts_products_at_the_dtypes_peak(itemsize, by):
    """mamba2-130m's prefill (B=8, T=512, H=24, P=64, N=128): 34 MB and
    4.5 GFLOP; bf16 at 989 TFLOP/s is bound by bytes (about 0.010 ms), fp32
    at 67 TFLOP/s by operations (about 0.067 ms)."""
    ms, bound_by = chip_smoke.ssd_bound(8, 512, 24, 1, 64, 128, 64, itemsize, False)
    assert bound_by == by
    assert ms == pytest.approx(0.0101 if itemsize == 2 else 0.0668, rel=0.02)


def test_ssd_kernel_reads_projection_views_in_place():
    d_inner, gn = 24 * 64, 128
    u = torch.zeros(2, 130, 2 * d_inner + 2 * gn + 24, dtype=torch.bfloat16)
    xbc = u[..., d_inner : 2 * d_inner + 2 * gn]
    x = xbc[..., :d_inner].reshape(2, 130, 24, 64)
    bm = xbc[..., d_inner : d_inner + gn].reshape(2, 130, 1, 128)
    assert not x.is_contiguous()
    assert ssd_mod._strided_ok(x) == (x.data_ptr() % 16 == 0)
    assert ssd_mod._strided_ok(bm) == (bm.data_ptr() % 16 == 0)
    flat = torch.zeros(2 * 130 * 24 * 64 + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(2, 130, 24, 64)               # misaligned by one element
    assert not ssd_mod._strided_ok(odd)
    assert not ssd_mod._strided_ok(torch.zeros(2, 130, 64, 24).transpose(2, 3))


def test_scan_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    g = torch.Generator().manual_seed(0)
    x, w_x = torch.randn(3, 5, 8, generator=g), torch.randn(8, 32, generator=g)
    w_h, b = torch.randn(8, 32, generator=g), torch.randn(32, generator=g)
    h0, c0 = torch.randn(3, 8, generator=g), torch.randn(3, 8, generator=g)
    before, by_path = lstm_scan.launches, dict(lstm_scan.launches_by_path)
    got = lstm_scan_layer(x, w_x, b, w_h, h0, c0)
    want = lstm_scan_layer_ref(x, w_x, b, w_h, h0, c0)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))
    assert lstm_scan.launches == before and dict(lstm_scan.launches_by_path) == by_path


@pytest.mark.parametrize("module", ["lstm_scan.lstm_scan", "ssd_scan.ssd_scan"])
def test_probe_build_is_keyed_apart_from_the_kernels_own(module):
    from repro_torch.kernels import _build

    source = importlib.import_module(f"repro_torch.kernels.{module}").SOURCE
    plain = _build.source_digest(source)
    assert plain == _build.source_digest(source, ())
    assert plain != _build.source_digest(source, ("KERNEL_PROBE",))
    assert "-DKERNEL_PROBE" not in _build.NVCC_FLAGS
    probe = (_build.INCLUDE_DIR / "probe.cuh").read_text()
    assert "#ifdef KERNEL_PROBE" in probe and '#include "probe.cuh"' in source.read_text()
