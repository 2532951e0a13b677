"""The program's own spans in a traced run's tail: the ``ava:`` regions
that ``ava256_tpu_torch`` opens while a profiler records
(``train/profiling.py`` ``annotate``), read on the thread that ran the
traced units (``bench_unit``), and what the device did under them.

- the host's time a unit inside some spans;
- the device time a unit of the work whose launch lies inside some spans
  (the launch found by its ``correlation``);
- the device's idle time a unit by what the host was inside: each idle gap
  of ``trace.busy_and_gaps`` cut by interval intersection with the
  innermost ``ava:`` span live on that thread, so the parts add up to the
  tail's idle time; where no span is live, ``UNSPANNED``.

Each reader returns None on a CPU run, on another loop's records, and where
the program opened no ``ava:`` span (a program without them); ``host_ms``
and ``launched_ms`` also where it opened none of those they read."""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

from benchmark.harness.trace import LAUNCH_CATS, UNIT, busy_and_gaps, device_events, units

PREFIX = "ava:"
UNSPANNED = "unspanned"  # no span live: benchmark code or unspanned program code
# the spans of each layer
INPUT = ("ava:collate", "ava:upload")
MODELS = ("ava:decode",)
RAYMARCH = ("ava:raymarch", "ava:raymarch.cull")
CULL = ("ava:raymarch.cull",)

Span = Tuple[float, float, str]


def _unit_thread(events: List[dict]):
    for e in events:
        if e.get("name") == UNIT and e.get("cat") == "user_annotation":
            return e.get("pid"), e.get("tid")
    return None


def program_spans(events: List[dict]) -> List[Span]:
    """(start, end, name) in us of the ``ava:`` spans on the units' thread
    that overlap the traced units, by start."""
    tail, thread = units(events), _unit_thread(events)
    if not tail:
        return []
    t0, t1 = tail[0][0], tail[-1][1]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)
                  and (e.get("pid"), e.get("tid")) == thread
                  and e["ts"] < t1 and e["ts"] + e["dur"] > t0)


def innermost(spans: List[Span], t0: float, t1: float) -> List[Span]:
    """[t0, t1] cut into pieces, each with the name of the innermost span
    live over all of it (the latest started; of two started together the
    shorter), or ``UNSPANNED``."""
    cuts = sorted({t0, t1} | {t for a, b, _ in spans for t in (a, b) if t0 < t < t1})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        live = [s for s in spans if s[0] <= a and b <= s[1]]
        name = max(live, key=lambda s: (s[0], -s[1]))[2] if live else UNSPANNED
        pieces.append((a, b, name))
    return pieces


def idle_us(events: List[dict], spans: List[Span]) -> Dict[str, float]:
    """The tail's idle device us by the innermost span the host was inside
    (its name, or ``UNSPANNED``): the parts add up to the gaps' sum."""
    tail = units(events)
    _, _, gaps = busy_and_gaps(events)
    pieces = innermost(spans, tail[0][0], tail[-1][1])
    out: Dict[str, float] = collections.Counter()
    i = 0
    for a, b in gaps:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                out[pieces[j][2]] += hi - lo
            j += 1
    return dict(out)


def _tail(rec, loop: str):
    """(units, spans) of a card run of ``loop``, or None."""
    if rec.get("loop") != loop or not rec.get("gpu"):
        return None
    events = rec.get("events") or []
    n = len(units(events))
    spans = program_spans(events)
    return (n, spans) if n and spans else None


def host_ms(rec, loop: str, names) -> Optional[float]:
    """Host ms a unit inside the spans ``names`` (spans that never nest in
    one another), in the tail."""
    got = _tail(rec, loop)
    if got is None:
        return None
    n, spans = got
    tail = units(rec["events"])
    t0, t1 = tail[0][0], tail[-1][1]
    mine = [min(b, t1) - max(a, t0) for a, b, name in spans if name in names]
    return sum(mine) / 1e3 / n if mine else None


def launched_ms(rec, loop: str, names) -> Optional[float]:
    """Device ms a unit of the work in the tail whose launch (matched by its
    ``correlation``) lies inside one of the spans ``names``."""
    got = _tail(rec, loop)
    if got is None:
        return None
    n, spans = got
    mine = [(a, b) for a, b, name in spans if name in names]
    if not mine:
        return None
    events = rec["events"]
    thread = _unit_thread(events)
    launch_ts = {(e.get("args") or {}).get("correlation"): e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS and (e.get("pid"), e.get("tid")) == thread}
    tail = units(events)
    t0, t1 = tail[0][0], tail[-1][1]
    us = 0.0
    for e in device_events(events):
        ts = launch_ts.get((e.get("args") or {}).get("correlation"))
        if t0 <= e["ts"] < t1 and ts is not None and any(a <= ts < b for a, b in mine):
            us += e.get("dur", 0)
    return us / 1e3 / n


def idle_ms(rec, loop: str, names) -> Optional[float]:
    """Device-idle ms a unit while the host's innermost span was one of
    ``names`` (``UNSPANNED``: no span)."""
    got = _tail(rec, loop)
    if got is None:
        return None
    n, spans = got
    by_name = idle_us(rec["events"], spans)
    return sum(by_name.get(k, 0.0) for k in names) / 1e3 / n
