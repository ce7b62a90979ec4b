"""The card's peaks and the least time a kernel's own work needs on it.

A kernel's roofline share is that least time over the kernel's device time
from the trace.  The least time is the larger of the bytes the call must
move over the memory bandwidth and its operations over the peak rate.  The
bytes count what the call's data needs read once and written once,
whatever the kernel reads again: the valid lane of every slot, and the
labels, times and table entries of the events the slots actually hold
(counted from the traced calls' outputs), not of every slot.  The count
is the same whichever body of the kernel runs.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense rates, at its 700 W limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12,
                              "tf32_ops_per_s": 495e12,
                              "bf16_ops_per_s": 989e12},
}


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind`` (KeyError for a card the table
    lacks: no share is computed against a guess)."""
    return PEAKS[kind]


def exchange_cost(*, launches: int, slots: int, n_dst: int, enables: int,
                  out_slots: int, out_rows: int, valid: int, kept: int
                  ) -> tuple[int, int]:
    """Bytes and integer operations of ``launches`` exchange rounds of
    ``slots`` egress frame slots each over ``n_dst`` destinations, with
    ``valid`` events entering and ``kept`` delivered in all.

    Bytes: the bool valid lane of every input and output slot, the
    enables and an int32 drop count a destination row, once a launch;
    the int32 label and forward entry of each valid event; the reverse
    entry and the int32 output label of each kept event.  A slot that
    holds no event costs its valid byte alone, since the frames pack
    their events to the front.  Operations: about ten per valid event and
    destination, and per output slot."""
    nbytes = (launches * (slots + enables + out_slots + out_rows * 4)
              + 8 * valid + 8 * kept)
    ops = 10 * (valid * n_dst + launches * out_slots)
    return nbytes, ops


def merge_cost(*, launches: int, slots: int, out_slots: int, out_rows: int,
               kept: int, timed: bool, label_bytes: int = 4
               ) -> tuple[int, int]:
    """Bytes and integer operations of ``launches`` merge-and-pack calls of
    ``slots`` merge-stream slots each into ``out_slots`` ingress slots over
    ``out_rows`` destinations, ``kept`` events delivered in all.

    Bytes: the bool valid lane of every input and output slot and an
    int32 drop count a row, once a launch; for each kept event its label
    (``label_bytes``), its reverse entry and its int32 output label, and,
    timed, its int32 time read and written.  An event past the capacity
    is counted by its valid byte alone.  Operations: about ten per output
    slot and per kept event."""
    per_kept = label_bytes + 4 + 4 + (8 if timed else 0)
    nbytes = launches * (slots + out_slots + out_rows * 4) + per_kept * kept
    ops = 10 * (launches * out_slots + kept)
    return nbytes, ops


def share(nbytes: int, ops: int, device_s: float, kind: str,
          ops_key: str = "f32_ops_per_s") -> float | None:
    """Percent of the roofline: the least time over ``device_s``; None
    when the kernel never ran."""
    if device_s <= 0:
        return None
    pk = peaks(kind)
    least = max(nbytes / pk["bytes_per_s"], ops / pk[ops_key])
    return 100.0 * least / device_s
