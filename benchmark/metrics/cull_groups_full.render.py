"""Share (%) of the traced tail's two-stage culled tiles whose group slots
(``cull_max_groups``) were all taken, so that any further group reaching
the tile was cut: the program's cull counters (``records["cull_counts"]``
of the ``render_counted`` loop)."""


def read(rec):
    counts = rec.get("cull_counts") if rec.get("loop") == "render" else None
    if not counts or not counts["tiles"]:
        return None
    return 100.0 * counts["groups_full"] / counts["tiles"]
