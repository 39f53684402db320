"""The share of K3's (128-sample tile, object) pairs that it ran, in %:
the program's counters k3.pairs_ran over k3.pairs of the traced steps (K4
runs the pairs of the K3 launch it differentiates). A pair runs when some
ray of the tile hits the object's box."""

from portbench import spans


def read(s):
    layers = spans.of(s)
    pairs = layers.counters.get("k3.pairs") if layers is not None else None
    return 100.0 * layers.counters["k3.pairs_ran"] / pairs if pairs else None
