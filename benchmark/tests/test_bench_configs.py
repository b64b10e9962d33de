"""Each configuration of BENCHMARK.json is a configuration of its own: no
two share the pair (``source``, ``reduced``), which is what tells a new
model or deployment from a cut of one already there. Two sources are the
same source when they name the same hosted repository, whatever file inside
it they point at, or when one URL lies under the other. Each configuration
file names a system that is a file under ``benchmark/systems/``, with its
reference under ``benchmark/reference/``, and states the source that
BENCHMARK.json gives it."""

import itertools
import os
from urllib.parse import urlsplit

import pytest

from conftest import ROOT

from benchmark import harness

# Hosts whose URLs name a repository by the first two parts of their path.
REPO_HOSTS = ("huggingface.co", "github.com", "gitlab.com")


def origin(source):
    """What a source names: a hosted repository as host/owner/name, in lower
    case; any other URL or citation as it is, without a trailing slash."""
    url = urlsplit(source.split()[0])
    host = url.netloc.lower().removeprefix("www.")
    if host in REPO_HOSTS:
        return "/".join([host] + url.path.strip("/").lower().split("/")[:2])
    return source.strip().rstrip("/")


def same_source(a, b):
    a, b = origin(a), origin(b)
    return a == b or a.startswith(b + "/") or b.startswith(a + "/")


def _configs():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))["configs"]


def test_no_two_configurations_share_their_source_and_cut():
    for a, b in itertools.combinations(_configs(), 2):
        assert not (same_source(a["source"], b["source"])
                    and sorted(a["reduced"]) == sorted(b["reduced"])), (a["name"], b["name"])


@pytest.mark.parametrize("a, b, same", [
    ("https://huggingface.co/tencent/Hunyuan3D-2",
     "https://huggingface.co/tencent/Hunyuan3D-2/blob/main/hunyuan3d-paint-v2-0-turbo/unet/config.json",
     True),
    ("https://huggingface.co/tencent/Hunyuan3D-2", "https://github.com/Tencent/Hunyuan3D-2", False),
    ("https://huggingface.co/tencent/Hunyuan3D-2", "https://huggingface.co/tencent/Hunyuan3D-2mini",
     False),
    ("https://huggingface.co/tencent/Hunyuan3D-2 (the dit-v2-0-fast folder)",
     "https://www.huggingface.co/Tencent/hunyuan3d-2/", True),
    ("https://arxiv.org/abs/2501.12202", "https://arxiv.org/abs/2501.12202/", True),
    ("https://arxiv.org/abs/2501.12202", "https://huggingface.co/tencent/Hunyuan3D-2", False),
])
def test_sources_that_name_one_repository_are_one_source(a, b, same):
    assert same_source(a, b) is same and same_source(b, a) is same


def test_each_configuration_names_its_system_and_reference():
    for c in _configs():
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "systems", cfg["system"] + ".py"))
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "reference", c["name"] + ".py"))


def test_each_configuration_file_states_its_source():
    for c in _configs():
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert same_source(cfg["source"], c["source"]), c["name"]
