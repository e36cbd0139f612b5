"""Host <-> device copies of a batch through a ring of page-locked slots.

A copy from pageable host memory (numpy arrays, the tensors ``.cpu()``
returns) is paced by the one host thread with which the CUDA driver
stages it through its own small pinned buffer, a few GB/s.  A copy from
page-locked memory is a DMA at the link's rate.  ``StagingRing`` keeps a
few page-locked slots, allocated once, and moves a batch through them in
slot-sized chunks:

- to the device (``to_device``): the batch's tensors are views at
  ``ALIGN``-byte offsets of one device byte buffer, and the host arrays
  are walked as one byte stream in that layout.  For each chunk the host
  waits for the slot's last DMA (only if it is still in flight), copies
  the host bytes into the slot with ``Tensor.copy_`` (spread over the
  intra-op threads; a dtype cast happens in this copy, rounding as
  ``Tensor.to`` does), issues the slot's DMA on the current stream and
  records the slot's event.  So the DMA of one chunk overlaps the staging
  of the next, and the kernels queued after it on the stream run behind
  it.  When ``to_device`` returns every host byte has been read.
- to the host (``to_host``): the tensors, as one byte stream of the same
  layout, are DMAed chunk by chunk into the slots, at most one chunk a
  slot in flight; the host waits for a slot's event and copies it out
  into fresh host arrays the caller owns (a cast happens in this copy).
  Fresh host memory taken page by page (a fault at each page's first
  write) would pace the copy out, so each array is a private anonymous
  mapping whose pages the kernel maps at once (``MAP_POPULATE``), made
  before the host first waits for a DMA: where the device is still busy
  with the kernels before the copy, that cost is hidden.

The slots' footprint is fixed (``SLOTS`` x ``SLOT_BYTES``), whatever the
batch.  Every call reads every byte of its inputs; nothing is kept across
calls but the slots and their events.

A process holds one ring for each CUDA device (``ring``), shared by every
caller that copies a batch to or from it (``Evaluator``, ``Trainer``,
``batch_to_tensors``' other callers): the pinned footprint stays one
ring's per device however many evaluators and trainers a process makes,
and a free function such as ``batch_to_tensors`` finds it without an
owner object.  A lock makes a transfer hold the ring whole.  A CPU
destination or source takes the plain path (``Tensor.to``, ``.numpy()``)
and stages nothing.

Each transfer adds its ring's bytes (``staged_nbytes``: the bytes written
at the far side) and the number of times the host found a slot still in
flight (``ring_waits``) to the innermost span that is recording
(``utils/logging.py::span_count``).
"""

from __future__ import annotations

import math
import mmap
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grounded_video_description_torch.utils.logging import span_count

SLOT_BYTES = 32 << 20   # a chunk's bytes
SLOTS = 4               # 128 MB of page-locked host memory a device
ALIGN = 256             # a tensor's offset in the stream, in bytes


class _Stream:
    """Runs of ``sizes`` bytes, each of elements of its ``itemsizes``, laid
    end to end at ``ALIGN``-aligned ``offsets``; ``total`` is the end of
    the last run.  A batch's tensors in the order given."""

    def __init__(self, sizes: Sequence[int], itemsizes: Sequence[int]):
        self.sizes, self.itemsizes = list(sizes), list(itemsizes)
        self.offsets, end = [], 0
        for n in sizes:
            start = -(-end // ALIGN) * ALIGN
            self.offsets.append(start)
            end = start + n
        self.total = end

    def pieces(self, c0: int, c1: int) -> List[Tuple[int, ...]]:
        """The pieces (j, a, b, e0, e1) of the runs ``j`` in the bytes
        [c0, c1): stream offsets a, b and run elements e0, e1.  Where c0
        and c1 are multiples of ``ALIGN`` (or ends of runs), a cut inside
        a run falls on an element boundary."""
        out = []
        for j, (o, n, k) in enumerate(zip(self.offsets, self.sizes,
                                          self.itemsizes)):
            a, b = max(c0, o), min(c1, o + n)
            if a < b:
                out.append((j, a, b, (a - o) // k, (b - o) // k))
        return out

    def chunks(self, step: int):
        """The stream in chunks of ``step`` bytes: (c0, c1, pieces)."""
        for c0 in range(0, self.total, step):
            c1 = min(c0 + step, self.total)
            yield c0, c1, self.pieces(c0, c1)


def _populated(shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """A fresh host tensor on its own private anonymous mapping, its pages
    faulted in by the kernel at once (``MAP_POPULATE``); the mapping goes
    with the last tensor or array that views it."""
    n = math.prod(shape) * dtype.itemsize
    if not n:
        return torch.empty(shape, dtype=dtype)
    buf = mmap.mmap(-1, n, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                    | mmap.MAP_POPULATE)
    return torch.frombuffer(buf, dtype=dtype).view(shape)


class StagingRing:
    """``slots`` host slots of ``slot_bytes`` for copies to and from
    ``device``: page-locked, with an event each, on a CUDA device; plain
    host memory and no events on the CPU, where the chunk loop runs the
    same and each copy is synchronous (the tests' stand-in)."""

    def __init__(self, device, slot_bytes: int = SLOT_BYTES,
                 slots: int = SLOTS):
        if slot_bytes % ALIGN:
            raise ValueError(f"slot_bytes {slot_bytes} is not a multiple "
                             f"of {ALIGN}")
        self.device = torch.device(device)
        self.slot_bytes = slot_bytes
        cuda = self.device.type == "cuda"
        buf = torch.empty(slots * slot_bytes, dtype=torch.uint8,
                          pin_memory=cuda)
        self._slots = list(buf.split(slot_bytes))
        self._events: List[Optional[torch.cuda.Event]] = (
            [torch.cuda.Event() for _ in self._slots] if cuda
            else [None] * slots)
        self._next = 0
        self._lock = threading.Lock()

    def _wait(self, i: int) -> int:
        """Waits for slot ``i``'s last DMA: 1 where it was still in
        flight, else 0."""
        ev = self._events[i]
        if ev is None or ev.query():      # (an event never recorded is done)
            return 0
        ev.synchronize()
        return 1

    def _acquire(self) -> Tuple[int, int]:
        """The next slot in turn, once its last DMA is done, and whether
        the host waited for it."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        return i, self._wait(i)

    def _record(self, i: int):
        """Records slot ``i``'s event behind the DMA just issued, on the
        device's current stream (the one ``copy_`` issued it on)."""
        if self._events[i] is not None:
            self._events[i].record(torch.cuda.current_stream(self.device)
                                   if self.device.type == "cuda" else None)

    def to_device(self, srcs: Sequence[torch.Tensor],
                  dtypes: Sequence[torch.dtype]) -> List[torch.Tensor]:
        """The host tensors ``srcs`` (contiguous) as tensors of ``dtypes``
        on the device: views of one device byte buffer, filled chunk by
        chunk through the slots."""
        st = _Stream([s.numel() * d.itemsize for s, d in zip(srcs, dtypes)],
                     [d.itemsize for d in dtypes])
        buf = torch.empty(st.total, dtype=torch.uint8, device=self.device)
        flat = [s.reshape(-1) for s in srcs]
        waits = 0
        with self._lock:
            for c0, c1, pieces in st.chunks(self.slot_bytes):
                i, waited = self._acquire()
                waits += waited
                slot = self._slots[i]
                for j, a, b, e0, e1 in pieces:
                    slot[a - c0:b - c0].view(dtypes[j]).copy_(flat[j][e0:e1])
                buf[c0:c1].copy_(slot[:c1 - c0], non_blocking=True)
                self._record(i)
        span_count(staged_nbytes=sum(st.sizes), ring_waits=waits)
        return [buf[o:o + n].view(d).view(s.shape)
                for o, n, d, s in zip(st.offsets, st.sizes, dtypes, srcs)]

    def to_host(self, tensors: Sequence[torch.Tensor],
                dtypes: Sequence[torch.dtype]) -> List[np.ndarray]:
        """The device ``tensors`` as fresh host arrays of ``dtypes``,
        through the slots."""
        srcs = [t.detach().contiguous().reshape(-1) for t in tensors]
        st = _Stream([s.numel() * s.element_size() for s in srcs],
                     [s.element_size() for s in srcs])
        raw = [s.view(torch.uint8) if s.numel() else s for s in srcs]
        outs = [_populated(t.shape, d) for t, d in zip(tensors, dtypes)]
        flat = [o.reshape(-1) for o in outs]
        pending = deque()

        def drain() -> int:
            """Copies out the oldest chunk in flight, once its DMA is
            done; 1 where the host waited for it."""
            i, c0, c1, pieces = pending.popleft()
            waited = self._wait(i)
            slot = self._slots[i]
            for j, a, b, e0, e1 in pieces:
                flat[j][e0:e1].copy_(slot[a - c0:b - c0].view(srcs[j].dtype))
            return waited

        waits = 0
        with self._lock:
            for c0, c1, pieces in st.chunks(self.slot_bytes):
                if len(pending) == len(self._slots):
                    waits += drain()
                i, waited = self._acquire()
                waits += waited
                slot = self._slots[i]
                for j, a, b, _, _ in pieces:
                    o = st.offsets[j]
                    slot[a - c0:b - c0].copy_(raw[j][a - o:b - o],
                                              non_blocking=True)
                self._record(i)
                pending.append((i, c0, c1, pieces))
            while pending:
                waits += drain()
        span_count(staged_nbytes=sum(o.nbytes for o in outs),
                   ring_waits=waits)
        return [o.numpy() for o in outs]


_rings: Dict[torch.device, StagingRing] = {}
_rings_lock = threading.Lock()


def ring(device) -> Optional[StagingRing]:
    """The process's ring for a CUDA ``device``, made at its first use;
    None for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _rings_lock:
        if device not in _rings:
            _rings[device] = StagingRing(device)
        return _rings[device]


def to_device(srcs: Dict[str, torch.Tensor], device,
              dtypes: Optional[Dict[str, torch.dtype]] = None
              ) -> Dict[str, torch.Tensor]:
    """The host tensors ``srcs`` on ``device``, each cast to its entry of
    ``dtypes`` where it has one: through the device's ring on a CUDA
    device, else by ``Tensor.to``."""
    dtypes = {k: (dtypes or {}).get(k, v.dtype) for k, v in srcs.items()}
    r = ring(device)
    if r is None:
        return {k: v.to(device=device, dtype=dtypes[k])
                for k, v in srcs.items()}
    keys = list(srcs)
    out = r.to_device([srcs[k].contiguous() for k in keys],
                      [dtypes[k] for k in keys])
    return dict(zip(keys, out))


def to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host arrays of ``tensors`` (bf16 becomes f32, which keeps every
    value): from a CUDA device through its ring, into fresh arrays; from
    the CPU, ``.numpy()`` of the tensor (or of its f32 copy)."""
    host = [torch.float32 if t.dtype == torch.bfloat16 else t.dtype
            for t in tensors]
    r = ring(tensors[0].device) if tensors else None
    if r is None:
        return [t.detach().to(d).numpy() for t, d in zip(tensors, host)]
    return r.to_host(tensors, host)
