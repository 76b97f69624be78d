"""Stream ms per step of the two optimiser updates (clip, AdamW, schedule),
from the program's own `train/g_update` and `train/d_update` spans
(`harness.program_spans`): their stream times summed over the window's
`train/step` spans."""

from harness.program_spans import by_name


def read(t):
    spans = by_name()
    steps = spans.get("train/step")
    updates = [spans[k] for k in ("train/g_update", "train/d_update") if k in spans]
    if not steps or not updates or not all(u.stream_calls for u in updates):
        return None
    return sum(u.stream_ms for u in updates) / steps.calls
