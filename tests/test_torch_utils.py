"""The port's config, test-data and profiler utilities, on the CPU.

Ports ``tests/test_hygiene.py:23-111`` and ``:273-281``: the packaged config
(the same keys and values as the JAX package's), the local short-circuit of
``get_test_file``, a ``file://`` URL unzipped through ``urllib``, the fsspec
``filecache::`` route with a fake ``fsspec``, the ``RuntimeError`` for an
absent file, and ``trace`` writing a trace file. No test reaches a network:
each route is given a local URL or a fake transport.
"""

import contextlib
import json
import os
import sys
import types
import zipfile

import pytest
import torch

import xsarsea_tpu.utils as ju
import xsarsea_tpu_torch
import xsarsea_tpu_torch.utils as u


def test_packaged_config_exists_and_loads(tmp_path, monkeypatch):
    pkg_cfg = os.path.join(os.path.dirname(xsarsea_tpu_torch.__file__), "config.yml")
    assert os.path.isfile(pkg_cfg), "packaged config.yml must ship with the wheel"
    monkeypatch.setenv("HOME", str(tmp_path))  # no user override
    cfg = u.load_config()
    assert cfg == ju.load_config() == {"data_dir": "/tmp"}
    # the user's file overrides the packaged one, key by key
    (tmp_path / ".xsarsea_tpu_torch").mkdir()
    (tmp_path / ".xsarsea_tpu_torch" / "config.yml").write_text(
        "test_data_url: file:///nowhere\n")
    assert u.load_config() == {"data_dir": "/tmp", "test_data_url": "file:///nowhere"}


def test_load_config_names_pyyaml_when_absent(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        u.load_config()


def test_get_test_file_local_short_circuit(tmp_path, monkeypatch):
    (tmp_path / "already_here.nc").write_bytes(b"x")
    monkeypatch.setattr(u, "load_config", lambda: {"data_dir": str(tmp_path)})
    assert u.get_test_file("already_here.nc") == str(tmp_path / "already_here.nc")


def _server(tmp_path, member, text):
    src = tmp_path / "server"
    src.mkdir()
    with zipfile.ZipFile(src / "fix.zip", "w") as zf:
        zf.writestr(member, text)
    return src


def test_get_test_file_file_url_and_unzip(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "fsspec", None)  # the urllib route
    src = _server(tmp_path, "fix/a.txt", "payload")
    data = tmp_path / "data"
    data.mkdir()
    monkeypatch.setattr(u, "load_config", lambda: {"data_dir": str(data),
                                                   "test_data_url": src.as_uri()})
    with pytest.warns(UserWarning, match="Downloading"):
        out = u.get_test_file("fix")
    assert out == str(data / "fix")
    assert (data / "fix" / "a.txt").read_text() == "payload"
    assert not (data / "fix.zip").exists()


def test_get_test_file_unzipped_file_url_renames_part(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "fsspec", None)
    src = tmp_path / "server"
    src.mkdir()
    (src / "plain.bin").write_bytes(b"raw")
    data = tmp_path / "data"
    data.mkdir()
    monkeypatch.setattr(u, "load_config", lambda: {"data_dir": str(data),
                                                   "test_data_url": src.as_uri()})
    with pytest.warns(UserWarning, match="Downloading"):
        out = u.get_test_file("plain.bin", iszip=False)
    assert open(out, "rb").read() == b"raw"
    assert sorted(os.listdir(data)) == ["plain.bin"]  # no .part left behind


def test_get_test_file_fsspec_filecache(tmp_path, monkeypatch):
    blob = tmp_path / "fix.zip"
    with zipfile.ZipFile(blob, "w") as zf:
        zf.writestr("fix/b.txt", "cached")
    seen = {}

    def fake_open(url, **kw):
        seen["url"], seen["kw"] = url, kw
        return contextlib.closing(open(blob, "rb"))

    monkeypatch.setitem(sys.modules, "fsspec", types.SimpleNamespace(open=fake_open))
    data = tmp_path / "data2"
    data.mkdir()
    monkeypatch.setattr(u, "load_config", lambda: {"data_dir": str(data)})
    with pytest.warns(UserWarning, match="Downloading"):
        out = u.get_test_file("fix")
    assert out == str(data / "fix")
    assert (data / "fix" / "b.txt").read_text() == "cached"
    assert seen["url"].startswith("filecache::https://")
    assert seen["kw"]["filecache"]["cache_storage"] == str(data / "fsspec_cache")


def test_get_test_file_missing_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "fsspec", None)
    monkeypatch.setattr(u, "load_config", lambda: {
        "data_dir": str(tmp_path), "test_data_url": (tmp_path / "no_server").as_uri()})
    monkeypatch.setattr("urllib.request.urlretrieve",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("no network")))
    with pytest.warns(UserWarning, match="Downloading"), \
            pytest.raises(RuntimeError, match="not found locally"):
        u.get_test_file("nope.zip")


def test_trace_writes_a_trace_file(tmp_path):
    with u.trace(tmp_path / "trace") as tr:
        torch.arange(16.0).sum()
    assert tr.path.startswith(str(tmp_path / "trace")) and tr.path.endswith(".pt.trace.json")
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
    assert any("aten::sum" in r.key for r in tr.profile.key_averages())
