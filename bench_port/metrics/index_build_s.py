"""The wall of `build_pipeline` on the seed's collection (the prewarm
included, as the CLI runs it)."""


def read(run):
    return run.build_s
