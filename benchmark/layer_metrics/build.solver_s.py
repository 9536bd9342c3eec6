"""``build.solver_s``: seconds of the solver's ``build()`` on the host
clock, ending in a synchronize (the build layer; moves ``setup_s``)."""


def read(ctx):
    return ctx["build_s"]
