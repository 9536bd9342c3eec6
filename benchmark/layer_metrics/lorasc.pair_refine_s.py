"""``lorasc.pair_refine_s``: seconds of the LORASC build's f64 refinement of
the σ pairs (the program's build stage ``pair_refine``, span
``build.pair_refine``, synchronised at both ends), as the entry hands the
build's stages over with the operator. Nothing where the build has no such
stage (a program that refines the pairs elsewhere, or not at all)."""


def read(ctx):
    stages = (ctx["operator"] or {}).get("stages") or {}
    return stages.get("pair_refine")
