"""layout_s: host seconds of the decider and the layout build (the port's
``InputProperty.decider()`` then ``build_tensors()``), timed by the
harness around the two calls."""


def read(ctx):
    return ctx.layout_s
