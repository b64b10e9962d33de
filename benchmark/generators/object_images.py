"""Generator ``object_images``: one seeded object image a request, and the
entry call's noise seed (numpy only).

The traffic file's parameters:

* ``pool``: how many distinct images a run makes before its window; the
  window cycles through them, each request with a noise seed of its own;
* ``image``: the parameters of :func:`object_image`;
* ``call``: the keyword arguments of the entry call, the same for every
  request.

Every image has the same size; only the content and the noise seeds change
with the seed.
"""

from __future__ import annotations

import numpy as np


def object_image(rng: np.random.Generator, size: int, radius, lobes, harmonics: int,
                 colors: int) -> np.ndarray:
    """A seeded opaque star-shaped blob with smooth seeded colours on a
    transparent ground: uint8 RGBA [size, size, 4].

    The outline is r(θ) = r0·(1 + Σ a_k cos(n_k θ + φ_k)) around a jittered
    centre, r0 drawn from ``radius`` (a share of the image side), each of
    the ``harmonics`` terms from ``lobes`` lobes; the colour is a blend of
    ``colors`` seeded colours by seeded exponential ramps, with a little
    seeded noise. Each plane is computed apart, in float32."""
    g = (np.arange(size, dtype=np.float32) + 0.5) / size
    cy, cx = 0.5 + rng.uniform(-0.05, 0.05, 2)
    r0 = rng.uniform(*radius)
    dy, dx = (g - np.float32(cy))[:, None], (g - np.float32(cx))[None, :]
    theta = np.arctan2(dy, dx)
    r = np.ones_like(theta)
    for _ in range(harmonics):
        n = rng.integers(lobes[0], lobes[1] + 1)
        a, phi = rng.uniform(0.03, 0.15), rng.uniform(0, 2 * np.pi)
        r += np.float32(a) * np.cos(np.float32(n) * theta + np.float32(phi))
    inside = dy * dy + dx * dx < np.float32(r0) ** 2 * r * r
    palette = rng.uniform(30, 230, (colors, 3))
    ramps = [np.exp(np.float32(3 * np.cos(a)) * g[None, :] + np.float32(3 * np.sin(a)) * g[:, None])
             for a in rng.uniform(0, 2 * np.pi, colors)]
    total = sum(ramps)
    noise = rng.integers(-10, 11, (3, size, size), dtype=np.int8)
    img = np.zeros((size, size, 4), np.uint8)
    for c in range(3):
        plane = sum(np.float32(palette[k, c]) * ramps[k] for k in range(colors)) / total
        img[..., c] = np.where(inside, np.clip(plane + noise[c], 0, 255), 0).astype(np.uint8)
    img[..., 3] = inside * np.uint8(255)
    return img


def pool(traffic: dict, seed: int, stream: int = 0, count: int = None) -> list:
    """The ``count`` distinct inputs (``traffic["pool"]`` by default) of
    ``seed``'s series ``stream``: each ``{"image": uint8 RGBA, "call": the
    entry call's keywords}``."""
    rng = np.random.default_rng([seed, stream])
    spec = traffic["image"]
    return [{"image": object_image(rng, spec["size"], spec["radius"], spec["lobes"],
                                   spec["harmonics"], spec["colors"]),
             "call": dict(traffic["call"])}
            for _ in range(traffic["pool"] if count is None else count)]


def request(traffic: dict, pool: list, seed: int, stream: int, i: int) -> dict:
    """Request ``i`` of ``seed``'s series ``stream``: the pool's input
    ``i mod len(pool)`` (as the system prepared it) with a noise seed of its
    own, so that no two requests of a run are alike."""
    noise = np.random.SeedSequence([seed, stream, i]).generate_state(2, np.uint32)
    return {**pool[i % len(pool)], "seed": int(noise[0]) << 30 ^ int(noise[1])}
