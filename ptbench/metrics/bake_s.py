"""Host seconds of the scene's load and bake (``app.main.load_pipeline``:
the glTF read, the BVH build and the device tables), part of set-up."""


def read(ctx):
    return ctx.bake_s
