"""bake_inpaint_s: the textured call's stages after the unwrap, mean
seconds a request over the window: the program's "Bake Geometry (device)"
(the UV raster, the views' rasters, masks and texel projections),
"Texture Baking (device)" (the views' colours into the texture, and its
download) and "Texture Inpaint" (host) scopes."""

SCOPES = ("Bake Geometry (device)", "Texture Baking (device)", "Texture Inpaint")


def read(run):
    seconds = [sum(t[s] for s in SCOPES) for t in run.timings if all(s in t for s in SCOPES)]
    return sum(seconds) / len(seconds) if seconds else None
