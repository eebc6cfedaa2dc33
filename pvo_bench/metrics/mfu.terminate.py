"""The algorithm's operations of the traced run's terminate calls (each
update call's real edges and steps: volumes, lookups, the operator and
the DBA; the filler's encoder on every frame) over the calls' seconds,
as a share of the card's 989 TFLOP/s bf16 dense peak."""

from pvo_bench import bounds


def read(run):
    flops, calls = run.data.get("flops"), run.data.get("call_s")
    if not flops or not calls:
        return None
    return 100.0 * sum(flops) / sum(calls) / bounds.PEAK_FLOP_S["bf16"]
