"""Process start to the first timed request: loading, building the kernels
where they are not built yet, the state and the warm-up requests."""


def read(ctx):
    return ctx.setup_s
