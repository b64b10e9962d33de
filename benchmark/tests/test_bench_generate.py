"""The traffic generator ``object_images``: the same seed makes the same
requests, another seed others of the same sizes, every request of a window
has a noise seed of its own, and the images are what the traffic file
describes."""

import numpy as np
import pytest

from benchmark import harness

from conftest import traffic_file

CELLS = ("oct380", "oct256")
gen = harness.load_file("generators", "object_images")


@pytest.mark.parametrize("name", CELLS)
def test_requests_are_deterministic_per_seed(name):
    traffic = traffic_file(name)
    assert traffic["generator"] == "object_images"
    a = gen.pool(traffic, 2 ** 31 + 3, count=4)
    b = gen.pool(traffic, 2 ** 31 + 3, count=4)
    c = gen.pool(traffic, 2 ** 31 + 4, count=4)
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x["image"], y["image"]) and x["call"] == y["call"] == traffic["call"]
        assert not np.array_equal(x["image"], z["image"]) and x["image"].shape == z["image"].shape
    ra = [gen.request(traffic, a, 2 ** 31 + 3, 0, i) for i in range(8)]
    rb = [gen.request(traffic, b, 2 ** 31 + 3, 0, i) for i in range(8)]
    rc = [gen.request(traffic, c, 2 ** 31 + 4, 0, i) for i in range(8)]
    assert [r["seed"] for r in ra] == [r["seed"] for r in rb]
    assert len({r["seed"] for r in ra + rc}) == 16
    assert all(0 <= r["seed"] < 2 ** 62 for r in ra)


def test_a_cycled_image_is_a_new_request():
    """The window cycles through the pool; request i and i + len(pool) share
    an image and differ in their noise seed."""
    traffic = traffic_file("oct380")
    pool = gen.pool(traffic, 11, count=2)
    first, again = gen.request(traffic, pool, 11, 0, 1), gen.request(traffic, pool, 11, 0, 3)
    assert first["image"] is again["image"] and first["seed"] != again["seed"]


@pytest.mark.parametrize("name", CELLS)
def test_the_pool_outlasts_a_window(name):
    """A window of today's program (oct380 57-65 requests, oct256 81-86)
    sends each image once."""
    assert traffic_file(name)["pool"] >= 96


def test_streams_are_independent():
    traffic = traffic_file("oct380")
    pool = gen.pool(traffic, 7, count=4)
    warm = gen.pool(traffic, 7, stream=1, count=2)
    assert all(not np.array_equal(w["image"], p["image"]) for w in warm for p in pool)
    window, warm_up = gen.request(traffic, pool, 7, 0, 0), gen.request(traffic, pool, 7, 1, 0)
    assert window["seed"] != warm_up["seed"]


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 17, 4_000_000_000])
def test_object_image(seed):
    spec = traffic_file("oct380")["image"]
    img = gen.object_image(np.random.default_rng(seed), spec["size"], spec["radius"],
                           spec["lobes"], spec["harmonics"], spec["colors"])
    assert img.shape == (spec["size"], spec["size"], 4) and img.dtype == np.uint8
    alpha = img[..., 3]
    assert set(np.unique(alpha)) == {0, 255}
    share = (alpha > 0).mean()
    assert 0.05 < share < 0.75
    # the object leaves a border: the preprocessors recentre it by its alpha
    assert not alpha[0].any() and not alpha[-1].any() and not alpha[:, 0].any()
    assert not img[alpha == 0, :3].any()
    assert img[alpha > 0, :3].std() > 5.0
