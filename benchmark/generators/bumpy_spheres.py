"""Generator ``bumpy_spheres``: one seeded closed mesh without UVs and one
seeded object image a request, and the request's noise seed (numpy only).

The mesh stands in for the shape stage's output, a watertight surface at
the face count a user sends to the paint stage. The traffic file's
parameters:

* ``pool``: how many distinct (mesh, image) pairs a run makes before its
  window; the window cycles through them, each request with a noise seed of
  its own;
* ``mesh``: the parameters of :func:`bumpy_sphere`;
* ``image``: the parameters of ``object_images.object_image`` (the image
  generator of the image → mesh cells, read as it is).
"""

from __future__ import annotations

import numpy as np

from benchmark import harness

_images = harness.load_file("generators", "object_images")


def bumpy_sphere(rng: np.random.Generator, faces: int, tolerance: float, bumps: int,
                 amplitude, frequency, stretch):
    """A latitude-longitude sphere with seeded low-frequency radial bumps:
    (vertices float32 [V, 3], faces int32 [F, 3]), outward winding, two pole
    fans and ring bands, F within ``faces`` ± ``tolerance`` (a share).

    The face count is drawn in the inner half of that range; M latitude
    bands of rings and 2M segments a ring give F = 2·segments·M. The radius
    is 1 + Σ a_b sin(π f_b (d_b · p) + φ_b) over ``bumps`` seeded directions
    d_b, with a_b from ``amplitude`` and f_b from ``frequency``, and each
    axis is then scaled by a factor from ``stretch``."""
    target = faces * rng.uniform(1 - tolerance / 2, 1 + tolerance / 2)
    bands = max(2, int(round(np.sqrt(target / 4))))
    segments = max(3, int(round(target / (2 * bands))))
    n_faces = 2 * segments * bands
    if abs(n_faces - faces) > tolerance * faces:
        raise ValueError(f"{n_faces} faces is not within {tolerance} of {faces}")
    theta = np.pi * np.arange(1, bands + 1) / (bands + 1)
    phi = 2 * np.pi * np.arange(segments) / segments
    ring = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None],
                     np.sin(theta)[:, None] * np.sin(phi)[None],
                     np.cos(theta)[:, None] * np.ones_like(phi)[None]], -1).reshape(-1, 3)
    p = np.concatenate([[[0.0, 0.0, 1.0]], ring, [[0.0, 0.0, -1.0]]])
    d = rng.normal(size=(bumps, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = rng.uniform(*amplitude, bumps)
    f = rng.uniform(*frequency, bumps)
    ph = rng.uniform(0, 2 * np.pi, bumps)
    r = 1.0 + (a * np.sin(np.pi * f * (p @ d.T) + ph)).sum(1)
    verts = (p * r[:, None] * rng.uniform(*stretch, 3)).astype(np.float32)

    # vertex 0 the north pole, then ``bands`` rings of ``segments``, then the south pole
    j = np.arange(segments)
    nxt = (j + 1) % segments
    south = 1 + bands * segments
    tris = [np.stack([np.zeros_like(j), 1 + j, 1 + nxt], 1)]
    for k in range(bands - 1):
        a0, b0 = 1 + k * segments, 1 + (k + 1) * segments
        tris += [np.stack([a0 + j, b0 + j, b0 + nxt], 1), np.stack([a0 + j, b0 + nxt, a0 + nxt], 1)]
    last = 1 + (bands - 1) * segments
    tris.append(np.stack([last + j, np.full_like(j, south), last + nxt], 1))
    tris = np.concatenate(tris).astype(np.int32)
    assert len(tris) == n_faces
    return verts, tris


def pool(traffic: dict, seed: int, stream: int = 0, count: int = None) -> list:
    """The ``count`` distinct inputs (``traffic["pool"]`` by default) of
    ``seed``'s series ``stream``: each ``{"mesh": (vertices, faces),
    "image": uint8 RGBA}``."""
    rng = np.random.default_rng([seed, stream])
    m, spec = traffic["mesh"], traffic["image"]
    out = []
    for _ in range(traffic["pool"] if count is None else count):
        mesh = bumpy_sphere(rng, m["faces"], m["tolerance"], m["bumps"], m["amplitude"],
                            m["frequency"], m["stretch"])
        image = _images.object_image(rng, spec["size"], spec["radius"], spec["lobes"],
                                     spec["harmonics"], spec["colors"])
        out.append({"mesh": mesh, "image": image})
    return out


# request i: the pool's input i mod len(pool) with a noise seed of its own,
# drawn from (seed, stream, i) as the image cells draw theirs
request = _images.request
