"""Stats filtering/sorting utilities.

A copy of ``pysdc_tpu/utils/stats.py``.  Covers the post-processing surface
of the reference's stats helpers (``helpers/stats_helper.py:4-111``): field-filtered extraction with
restart-aware pruning, sorting by any Entry field, and the one-call
``get_sorted``.
"""

from __future__ import annotations


def filter_stats(stats, recomputed=None, **conditions):
    """Entries matching the given Entry-field conditions (None = wildcard).

    When ``recomputed`` is given (any non-None value), entries invalidated
    by restarts are pruned: within each (time, type) group only the newest
    restart generation survives, and whole times flagged by a truthy
    ``_recomputed`` marker are dropped.
    """
    wanted = {field: v for field, v in conditions.items() if v is not None}
    picked = {
        e: val
        for e, val in stats.items()
        if all(getattr(e, field, None) == want for field, want in wanted.items())
    }
    if recomputed is None:
        return picked

    # newest restart generation per (time, type); groups that never
    # restarted have no entry here and survive untouched
    newest = {}
    for e in picked:
        if e.num_restarts:
            key = (e.time, e.type)
            newest[key] = max(newest.get(key, 0), e.num_restarts)
    picked = {
        e: val
        for e, val in picked.items()
        if e.num_restarts >= newest.get((e.time, e.type), 0)
    }

    # drop times whose final verdict is "this step was recomputed elsewhere"
    if wanted.get('type') != '_recomputed':
        markers = filter_stats(stats, recomputed=False, type='_recomputed')
        dead_times = {e.time for e, truthy in markers.items() if truthy}
        if dead_times:
            picked = {e: val for e, val in picked.items() if e.time not in dead_times}

    return picked


def sort_stats(stats, sortby):
    """(key_field, value) pairs ordered by the chosen Entry field."""
    return sorted(((getattr(e, sortby), val) for e, val in stats.items()), key=lambda kv: kv[0])


def get_list_of_types(stats):
    """Distinct entry types, in first-seen order."""
    return list(dict.fromkeys(e.type for e in stats))


def get_sorted(stats, sortby='time', **kwargs):
    return sort_stats(filter_stats(stats, **kwargs), sortby=sortby)
