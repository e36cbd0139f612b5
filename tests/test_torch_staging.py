"""The staging ring's chunk loop (``data/staging.py``) on the CPU, with
plain host buffers standing in for the page-locked slots: a batch of the
loader's keys and dtypes through slots small enough that the chunks cut
inside rows and across arrays, the bf16 cast in the staging copy, the
copy back into arrays the caller owns, the counts it adds to the span
recording around it, and the plain path that a CPU destination keeps."""

# first: one torch thread a process (-n 6 workers x 8 OpenMP threads, 8 cores)
import torch_threads  # noqa: F401

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grounded_video_description_torch.config import tiny_test_config
from grounded_video_description_torch.data import staging, synthetic_batch
from grounded_video_description_torch.data.staging import (
    ALIGN, StagingRing, _Stream)
from grounded_video_description_torch.engine.trainer import batch_to_device
from grounded_video_description_torch.models import batch_to_tensors
from grounded_video_description_torch.utils.logging import span, span_records


def _batch():
    """The loader's keys and dtypes (f32, int64, bool) at the tiny widths,
    with a zero-size array and a non-contiguous one added."""
    b = synthetic_batch(tiny_test_config(), 3, seed=1)
    del b["seg_id"]
    b["empty"] = np.zeros((3, 0, 4), np.float32)
    b["strided"] = np.arange(3 * 40, dtype=np.float32).reshape(3, 40)[:, ::3]
    return b


def _host(batch):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in batch.values()]


def test_the_stream_aligns_each_run_and_chunks_cover_each_byte_once():
    sizes, itemsizes = [5, 0, 300, 256, 1, 1000], [1, 4, 4, 8, 1, 2]
    st = _Stream(sizes, itemsizes)
    assert all(o % ALIGN == 0 for o in st.offsets)
    assert all(st.offsets[j] + sizes[j] <= st.offsets[j + 1]
               for j in range(len(sizes) - 1))
    assert st.total == st.offsets[-1] + sizes[-1]
    seen = [[] for _ in sizes]
    for c0, c1, pieces in st.chunks(512):
        assert c0 % 512 == 0 and c1 - c0 <= 512
        for j, a, b, e0, e1 in pieces:
            assert c0 <= a < b <= c1
            k, o = itemsizes[j], st.offsets[j]
            assert (e0 * k, e1 * k) == (a - o, b - o)
            seen[j].append((a, b))
    for j, n in enumerate(sizes):
        runs = sorted(seen[j])
        assert sum(b - a for a, b in runs) == n
        assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))
    assert len(seen[5]) == 3 and len(seen[1]) == 0     # cut twice


@pytest.mark.parametrize("slot_bytes", [ALIGN, 3 * ALIGN])
def test_a_batch_comes_through_the_ring_byte_identical(slot_bytes):
    """Slots of 256 and 768 bytes: every array but the smallest is cut
    inside its rows, and chunks hold the ends of one array and the start
    of the next."""
    batch = _batch()
    srcs = _host(batch)
    ring = StagingRing("cpu", slot_bytes=slot_bytes, slots=3)
    out = ring.to_device(srcs, [s.dtype for s in srcs])
    assert {s.dtype for s in out} == {torch.float32, torch.int64, torch.bool}
    for k, s, o in zip(batch, srcs, out):
        assert o.dtype == s.dtype and o.shape == s.shape, k
        assert o.numpy().tobytes() == s.numpy().tobytes(), k
    # the arrays are views of one buffer, at aligned offsets
    base = out[0].untyped_storage().data_ptr()
    for o in out:
        assert o.untyped_storage().data_ptr() == base
        assert not o.numel() or (o.data_ptr() - base) % ALIGN == 0
    assert ring.to_device([], []) == []


def test_the_bf16_cast_in_the_staging_copy_rounds_as_tensor_to():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(37, 29, generator=g) * torch.logspace(-30, 30, 29)
    x[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"), -0.])
    x[1, :3] = torch.tensor([1 + 2**-8, 1 + 3 * 2**-8, -(1 + 2**-8)])  # ties
    ring = StagingRing("cpu", slot_bytes=2 * ALIGN, slots=2)
    n = torch.arange(5)
    got, idx = ring.to_device([x, n], [torch.bfloat16, torch.int64])
    want = x.to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(idx, n)
    assert got.view(torch.int16).tolist() == want.view(torch.int16).tolist()


def test_arrays_copied_back_are_the_callers():
    """The copy back: fresh arrays (bf16 as f32), unchanged by a second
    call through the same ring, and no view of the ring or the source."""
    ring = StagingRing("cpu", slot_bytes=ALIGN, slots=2)
    g = torch.Generator().manual_seed(4)
    first = [torch.randn(10, 31, generator=g),
             torch.randint(0, 9, (7, 5), generator=g),
             torch.randn(40, generator=g).to(torch.bfloat16),
             torch.rand(6, 6, generator=g) > 0.5,
             torch.randn(12, 9, generator=g).t()]
    dtypes = [torch.float32, torch.int64, torch.float32, torch.bool,
              torch.float32]
    got = ring.to_host(first, dtypes)
    keep = [a.copy() for a in got]
    for t, a in zip(first, got):
        want = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        assert a.dtype == want.dtype and np.array_equal(a, want)
        assert not any(np.shares_memory(a, slot.numpy())
                       for slot in ring._slots)
        assert not np.shares_memory(a, t.numpy() if t.dtype !=
                                    torch.bfloat16 else want)
    # each array on a mapping of its own, writable, and kept by the array
    assert all(a.flags.writeable for a in got)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(got)
                   for b in got[i + 1:])
    second = [torch.ones_like(t) for t in first]
    assert [a.tolist() for a in ring.to_host(second, dtypes)] == [
        (t.float() if t.dtype == torch.bfloat16 else t).tolist()
        for t in second]
    for t in first:
        t.zero_()
    for a, k in zip(got, keep):
        assert np.array_equal(a, k)
    assert ring.to_host([], []) == []


class Busy:
    """A stand-in event: in flight from its record to a synchronize."""
    def __init__(self):
        self.pending = False

    def query(self):
        return not self.pending

    def synchronize(self):
        self.pending = False

    def record(self, stream):
        self.pending = True


def test_the_span_records_the_ring_bytes_and_waits():
    """Under a profile, the bytes of a transfer and the slots found in
    flight (a stand-in event that is still busy at its first query) are
    added to the innermost recording span."""

    ring = StagingRing("cpu", slot_bytes=ALIGN, slots=2)
    ring._events = [Busy(), Busy()]
    x = torch.arange(300, dtype=torch.float32)       # 1200 bytes: 5 chunks
    with profile(activities=[ProfilerActivity.CPU]):
        with span("h2d", nbytes=x.nbytes):
            (y,) = ring.to_device([x], [torch.float32])
        ring._events = [Busy(), Busy()]    # the DMAs in done
        with span("d2h", nbytes=x.nbytes):
            with span("inner"):
                ring.to_host([y], [torch.float32])
    h2d, inner, d2h = span_records()[-3:]
    assert (h2d.name, inner.name, d2h.name) == ("h2d", "inner", "d2h")
    assert torch.equal(y, x)
    # in: the first use of each slot finds no DMA; the other 3 chunks wait
    assert (h2d.staged_nbytes, h2d.ring_waits) == (1200, 3)
    # back: each of the 5 chunks waits for its DMA, counted in the inner span
    assert (inner.staged_nbytes, inner.ring_waits) == (1200, 5)
    assert (d2h.staged_nbytes, d2h.ring_waits) == (0, 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_cpu_destination_keeps_the_plain_path(dtype):
    """To the CPU no ring is made and nothing is staged: the f32 arrays
    come back as the loader's own memory, the bf16 banks as Tensor.to's."""
    cfg = tiny_test_config(dtype=dtype)
    batch = synthetic_batch(cfg, 3, seed=2)
    with profile(activities=[ProfilerActivity.CPU]):
        got = batch_to_device(cfg, batch, "cpu")
    (rec,) = [r for r in span_records()[-1:] if r.name == "h2d"]
    assert rec.staged_nbytes == 0 and rec.ring_waits == 0
    assert rec.nbytes == sum(t.nbytes for t in got.values())
    assert staging.ring("cpu") is None
    for k, v in batch.items():
        if k == "seg_id":
            assert k not in got
            continue
        want = torch.from_numpy(v)
        if dtype == "bfloat16" and k in ("seg_feat", "ppls_feat"):
            assert torch.equal(got[k].view(torch.int16),
                               want.to(torch.bfloat16).view(torch.int16))
        else:
            assert got[k].data_ptr() == want.data_ptr()
    plain = batch_to_tensors(batch, "cpu")
    assert all(torch.equal(plain[k], torch.from_numpy(batch[k]))
               for k in plain)
    out = staging.to_host([plain["seg_feat"],
                           plain["seg_feat"].to(torch.bfloat16)])
    assert np.shares_memory(out[0], batch["seg_feat"])
    assert out[1].dtype == np.float32
