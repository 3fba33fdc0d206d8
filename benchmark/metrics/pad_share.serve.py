"""``pad_share.serve``: the share of the rows the server computed over the
window that were bucket padding, both towers (``InferenceServer.stats()``:
Σ bucket · dispatches at that bucket, less the rows served, over the
former)."""


def read(cell, outcome):
    computed = outcome.work.get("rows_computed", 0)
    if not computed:
        return None
    return 100.0 * (computed - outcome.work["rows_served"]) / computed
