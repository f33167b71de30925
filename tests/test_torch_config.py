"""The port's config tier chain (seaweedfs_tpu_torch/utils/config.py)
against the JAX package's: the same file found on the chain, the same
parsed tables (tomllib and the fallback subset parser), the same dotted
lookups; and the volume verb's security.toml tier — flags win, absent flags
fall back to the file — giving the same guard as the JAX package's verb."""

import argparse

import pytest

from seaweedfs_tpu import __main__ as ref_main
from seaweedfs_tpu.utils import config as ref_cfg
from seaweedfs_tpu_torch import __main__ as port_main
from seaweedfs_tpu_torch.utils import config as port_cfg

SECURITY = """# a cluster's security.toml
[jwt.signing]
key = "toml-write-key"
expires_after_seconds = 10

[jwt.signing.read]
key = 'toml-read-key'

[guard]
white_list = ["10.0.0.0/8", "127.0.0.1"]

[grpc]
ca = "/etc/swtpu/ca.crt"   # comment after a value
server_name = "swtpu"

[master.maintenance]
scripts = '''
  ec.encode -fullPercent=95
  volume.balance -force
'''
sleep_minutes = 17
ratio = 0.25
flags = [1, 2, 3]
"""


@pytest.fixture
def config_dir(tmp_path, monkeypatch):
    """A config directory first on the chain; the working directory moved
    to an empty one so './security.toml' finds nothing else."""
    d = tmp_path / "etc"
    d.mkdir()
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("SWTPU_CONFIG_DIR", str(d))
    return d


def test_chain_and_lookup_equal(config_dir):
    assert port_cfg.search_dirs() == ref_cfg.search_dirs()
    assert port_cfg.search_dirs()[0] == str(config_dir)
    assert port_cfg.find_config("security") is None
    assert port_cfg.load_config("security") == {} == \
        ref_cfg.load_config("security")
    (config_dir / "security.toml").write_text(SECURITY)
    assert port_cfg.find_config("security") == \
        ref_cfg.find_config("security") == str(config_dir / "security.toml")
    got, want = (m.load_config("security") for m in (port_cfg, ref_cfg))
    assert got == want
    for key in ("jwt.signing.key", "jwt.signing.read.key", "guard.white_list",
                "grpc.ca", "grpc.cert", "master.maintenance.sleep_minutes",
                "master", "nope.deeper", "jwt.signing.key.more"):
        assert port_cfg.get_dotted(got, key, "dflt") == \
            ref_cfg.get_dotted(want, key, "dflt"), key
    flat = {"a.b": 1, "a": {"b": 2}}
    assert port_cfg.get_dotted(flat, "a.b") == ref_cfg.get_dotted(flat, "a.b")


def test_fallback_parser_equal():
    """The subset parser used where neither tomllib nor tomli exists."""
    got = port_cfg._parse_toml_subset(SECURITY)
    assert got == ref_cfg._parse_toml_subset(SECURITY)
    assert got["master"]["maintenance"]["sleep_minutes"] == 17
    assert got["jwt"]["signing"]["read"]["key"] == "toml-read-key"
    for bad in ("key value", "x = 2020-01-01T00:00:00", "s = '''open"):
        errs = []
        for mod in (port_cfg, ref_cfg):
            with pytest.raises(ValueError) as e:
                mod._parse_toml_subset(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]


def _opt(**flags):
    base = {"jwtSigningKey": "", "jwtReadSigningKey": "", "whiteList": ""}
    base.update(flags)
    return argparse.Namespace(**base)


def _guard_fields(g):
    if g is None:
        return None
    return {k: getattr(g, k) for k in (
        "white_list", "signing_key", "read_signing_key", "expires_after_sec",
        "read_expires_after_sec")}


@pytest.mark.parametrize("toml", ["", "all", "write-only"])
@pytest.mark.parametrize("flags", [
    {}, {"jwtSigningKey": "flag-key"}, {"whiteList": "1.2.3.4,5.6.7.0/24"},
    {"jwtReadSigningKey": "flag-read", "jwtSigningKey": "flag-key"}])
def test_volume_verb_security_tier_equal(config_dir, toml, flags):
    if toml == "all":
        (config_dir / "security.toml").write_text(SECURITY)
    elif toml == "write-only":
        (config_dir / "security.toml").write_text(
            '[jwt.signing]\nkey = "only-write"\n')
    got = _guard_fields(port_main._make_guard(_opt(**flags)))
    want = _guard_fields(ref_main._make_guard(_opt(**flags)))
    assert got == want
    if toml == "all" and not flags.get("jwtSigningKey"):
        assert got["signing_key"] == "toml-write-key"
    if flags.get("jwtSigningKey"):
        assert got["signing_key"] == "flag-key"  # the flag wins
    if not toml and not flags:
        assert got is None


def test_volume_verb_has_qos_flag():
    p = argparse.ArgumentParser()
    port_main._volume_flags(p)
    opt = p.parse_args(["-qosPolicy", "/x/policy.json"])
    assert opt.qosPolicy == "/x/policy.json"
    assert p.parse_args([]).qosPolicy == ""
