"""The 95th percentile of every request's latency in the window, from
its client's submission to its logits on the host (inclusive quantiles,
as Python's ``statistics.quantiles`` gives them)."""
import statistics


def read(record):
    lat = record.get("latencies_ms") if record.get("kind") == "prefill" else None
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
