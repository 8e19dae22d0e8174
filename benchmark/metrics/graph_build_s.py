"""Graphs (``learn/graphs.py`` ``CompiledIteration``): seconds spent making
the iteration's CUDA graphs in set-up, each graph's eager warm-up, capture
and instantiation summed over ``CompiledIteration.reports()``."""


def read(ctx):
    reports = ctx["reports"]
    if not reports:
        return None
    ms = sum((r.get("warmup_ms") or 0.0) + (r.get("capture_ms") or 0.0) + (r.get("instantiate_ms") or 0.0)
             for r in reports)
    return ms / 1e3
