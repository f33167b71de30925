"""The reference's S3 conformance cases (tests/test_s3_conformance.py and
tests/test_s3_conformance_ext.py, each modelled on a ceph/s3-tests case)
run against the port's gateway: seaweedfs_tpu_torch.s3.S3Gateway over the
port's FilerServer over a cluster of the port (tests/torch_cluster.py) on
the CPU.

The case functions are the reference's own, imported unchanged; they speak
plain HTTP to the `s3`, `s3_auth` and `bucket` fixtures, which this module
defines, so pytest resolves them here to the port's gateway (open, and
with the reference's IAM_CONFIG)."""

import inspect
import uuid

import pytest
import requests

import test_s3_conformance as conf
import test_s3_conformance_ext as conf_ext
import torch_cluster as tc
from test_s3 import IAM_CONFIG

from seaweedfs_tpu_torch.filer.filer_server import FilerServer
from seaweedfs_tpu_torch.s3.s3_server import S3Gateway


@pytest.fixture(scope="module")
def port_filer(tmp_path_factory):
    c = tc.start(tmp_path_factory.mktemp("s3-conf-cluster"),
                 volume_size_limit_mb=64)
    fs = FilerServer(c["master"].address, store_spec="memory",
                     port=tc.free_port_pair(), chunk_size_mb=1).start()
    yield fs
    fs.stop()
    tc.stop(c)


def _gateway(fs, **kw):
    gw = S3Gateway(fs, port=tc.free_port_pair(), **kw).start()
    base = f"http://{gw.url}"
    tc.wait_until(lambda: requests.get(base, timeout=1) is not None,
                  timeout=10, msg="s3 gateway up")
    return gw, base


@pytest.fixture(scope="module")
def s3(port_filer):
    gw, base = _gateway(port_filer)
    yield gw, base
    gw.stop()


@pytest.fixture(scope="module")
def s3_auth(port_filer):
    gw, base = _gateway(port_filer, iam_config=IAM_CONFIG)
    yield gw, base
    gw.stop()


@pytest.fixture()
def bucket(s3):
    """A fresh bucket per test (s3tests get_new_bucket())."""
    gw, base = s3
    name = f"conf-{uuid.uuid4().hex[:10]}"
    assert requests.put(f"{base}/{name}", timeout=10).status_code == 200
    return base, name


def _cases(module):
    return {name: fn for name, fn in vars(module).items()
            if name.startswith("test_") and inspect.isfunction(fn)
            and fn.__module__ == module.__name__}


# the reference's 106 cases, under their own names, bound to this module's
# fixtures
_CASES = {**_cases(conf), **_cases(conf_ext)}
globals().update(_CASES)


def test_all_reference_cases_are_collected():
    assert len(_CASES) == len(_cases(conf)) + len(_cases(conf_ext)) == 106
