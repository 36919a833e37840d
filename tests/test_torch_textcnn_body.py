"""What surrounds the f32 TextCNN forward's two bodies, on the CPU: the
launcher's choice of body by shape (`ops.textcnn.fwd_body`), the names
of the forward's device functions (the benchmark's roofline reads every
kernel whose name holds `textcnn_pool_fwd`), the rows form's entry in
`KERNELS` against its C signature, and the benchmark's reader of the
warpgroup body's share of the rows launches. The kernels themselves run
only on the card (`chip_smoke.py`, phase `rows`)."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from reviews4rec_torch.ops import textcnn
from reviews4rec_torch.train import profiler

ROOT = Path(__file__).resolve().parents[1]
FWD_SRC = ROOT / "reviews4rec_torch" / "csrc" / "textcnn_pool_fwd.cu"
METRICS = ROOT / "portbench" / "metrics"


def _reader(stem: str):
    spec = importlib.util.spec_from_file_location(
        "metric_" + stem.replace(".", "_"), METRICS / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (form, E, F, W) -> body: the entity towers' training and serving shape
# and a rank call's chunk (the same widths), the NARRE tower (dense x),
# the fused word gather, the wide E of chip_smoke.py's rows dG checks,
# and the widths the warpgroup body is not built for
BODIES = {
    ("rows", 64, 100, 3): "wgmma",      # deepconn.train, deepconn.rank
    ("rows", 64, 104, 3): "wgmma",      # F fills the 13 n8 tiles
    ("rows", 64, 97, 3): "wgmma",
    ("x", 64, 100, 3): "mma_sync",      # NARRE, plain-x serving
    ("ids", 64, 100, 3): "mma_sync",    # the fused word gather
    ("rows", 256, 100, 3): "mma_sync",  # chip_smoke.py's wide E
    ("rows", 512, 100, 3): "mma_sync",
    ("rows", 32, 100, 5): "mma_sync",
    ("rows", 64, 100, 5): "mma_sync",
    ("rows", 64, 96, 3): "mma_sync",    # 12 n8 tiles: the product's 13th idle
    ("rows", 64, 129, 3): "mma_sync",   # two filter chunks
}


@pytest.mark.parametrize("shape", list(BODIES), ids=lambda s: "-".join(
    map(str, s)))
def test_fwd_body_by_shape(shape):
    assert textcnn.fwd_body(*shape) == BODIES[shape]


def test_wgmma_body_fits_the_cards_shared_memory():
    # K's two copies, four x tiles, eight barriers, a merge key a filter:
    # all the shared memory a block may have
    want = 2 * 3 * 8 * 13 * 256 + 4 * 66 * 68 * 4 + 8 * 8 + 104 * 8
    assert textcnn.wgmma_smem_bytes(64, 3) == want == 232448
    assert want <= textcnn.SMEM_OPTIN
    # a wider tap would not fit beside the ring
    assert textcnn.wgmma_smem_bytes(64, 4) > textcnn.SMEM_OPTIN


def _globals(src: str):
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)", src)


def test_every_forward_device_function_feeds_the_roofline():
    names = _globals(FWD_SRC.read_text())
    assert "textcnn_pool_fwd_rows_wgmma_kernel" in names
    assert "textcnn_pool_fwd_kernel" in names
    assert all("textcnn_pool_fwd" in n for n in names), names
    # the benchmark's reader sums the device time of exactly such names
    roof = _reader("kernel.textcnn_fwd.roofline")
    record = {"trace": {"kernels": {
        f"void (anonymous namespace)::{n}<3, 8>(float const*)": 1e-3
        for n in names}}, "slice": {"fwd_bound_s": 1e-3 * len(names)}}
    assert roof.read(record) == pytest.approx(100.0)


def _c_args(entry: str):
    """(pointers, ints) before the stream of a C entry point of the
    forward's source."""
    sig = re.search(rf"int {entry}\(([^)]*)\)", FWD_SRC.read_text()).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert params[-1] == "void* stream"
    params = params[:-1]
    return (sum("*" in p for p in params),
            sum("*" not in p and p.startswith("int ") for p in params))


def test_kernels_keeps_the_rows_forward_entry():
    spec = textcnn.KERNELS[textcnn.FWD_ROWS]
    assert spec.source == textcnn.FWD
    assert spec.entry == "textcnn_pool_fwd_rows_f32"
    assert spec.form == "rows" and spec.dtype == torch.float32
    assert spec.args == (7, 6) == _c_args(spec.entry)
    # the counter of the warpgroup body's launches rides on the rows name
    assert textcnn.FWD_ROWS_WGMMA == "textcnn_pool_fwd_rows.wgmma"
    assert textcnn.FWD_ROWS_WGMMA not in textcnn.KERNELS


@pytest.mark.parametrize("counts,want", [
    ({}, None),
    ({"textcnn_pool_fwd_rows": 0}, None),
    ({"textcnn_pool_fwd_rows": 8}, 0.0),
    ({"textcnn_pool_fwd_rows": 8, "textcnn_pool_fwd_rows.wgmma": 8}, 100.0),
    ({"textcnn_pool_fwd_rows": 8, "textcnn_pool_fwd_rows.wgmma": 2}, 25.0),
])
def test_wgmma_share_reader(monkeypatch, counts, want):
    monkeypatch.setattr(profiler, "counters", dict(counts))
    assert _reader("kernel.textcnn_fwd.wgmma_share").read({}) == want


def test_wgmma_share_reader_is_silent_without_the_body(monkeypatch):
    monkeypatch.setattr(profiler, "counters", {"textcnn_pool_fwd_rows": 8})
    monkeypatch.delattr(textcnn, "FWD_ROWS_WGMMA")
    assert _reader("kernel.textcnn_fwd.wgmma_share").read({}) is None


def test_rows_launch_on_the_cpu_counts_nothing(monkeypatch):
    monkeypatch.setattr(profiler, "counters", {})
    g = torch.Generator().manual_seed(0)
    table = torch.randn(4, 20, 64, generator=g)
    k = torch.randn(3 * 64, 100, generator=g)
    bias = torch.randn(100, generator=g)
    rows = torch.tensor([3, 0, 3], dtype=torch.int32)
    out, idx = textcnn.textcnn_pool_forward(table, k, bias, 3, rows=rows)
    ref, ref_idx = textcnn.textcnn_pool_reference(table[rows.long()], k,
                                                  bias, 3)
    assert torch.equal(out, ref) and torch.equal(idx, ref_idx)
    assert profiler.counters == {}
