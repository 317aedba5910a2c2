"""The port's dataset registry and file loaders (gorse_tpu_torch/data/
registry.py, data/loaders.py, the bench's datasets) against gorse_tpu's,
on the CPU. Nothing is downloaded: every zip is built here, from rows drawn
from a seed with numpy, and served from a ``file://`` mirror or from an
``http.server`` on 127.0.0.1.

- ``locate_built_in`` fetches, verifies (sha256 from a sidecar or a pinned
  checksum), extracts and caches, through either mirror kind, in both
  packages alike; a partial cache repairs itself; without a mirror it
  raises; a wrong format raises.
- A checksum mismatch and a zip entry escaping the cache (``../``, an
  absolute path) are refused, the cache left without the escaped file.
- ``convert_movielens_ncf`` writes the reference's ``train.txt`` and
  ``test.txt`` byte for byte, from ml-1m and ml-100k raw formats.
- ``load_built_in`` (NCF, the file's fixed negatives) and
  ``load_built_in_ctr`` (libFM) give the reference's datasets, exactly;
  ``bench ctr`` runs on a registry dataset.
"""

import hashlib
import http.server
import threading
import zipfile
from functools import partial

import numpy as np
import pytest

import gorse_tpu.data.loaders as RL
import gorse_tpu.data.registry as RR
import gorse_tpu_torch.data.loaders as PL
import gorse_tpu_torch.data.registry as PR

PACKAGES = {"ref": (RR, RL), "port": (PR, PL)}


def _ncf_files(seed: int, n_users: int = 12, n_items: int = 30):
    rng = np.random.default_rng(seed)
    train, test = [], []
    for u in range(n_users):
        items = rng.choice(n_items, 6, replace=False)
        train += [f"{u}\t{int(i)}" for i in items[:5]]
        negs = [int(i) for i in rng.choice(n_items, 4, replace=False) if i not in items]
        test.append(f"({u},{int(items[5])})\t" + "\t".join(map(str, negs)))
    return "\n".join(train) + "\n", "\n".join(test) + "\n"


def _libfm(seed: int, rows: int):
    rng = np.random.default_rng(seed)
    return "".join(
        f"{int(rng.integers(2))} " + " ".join(f"{int(f)}:{float(rng.integers(1, 3))}"
                                              for f in sorted(rng.choice(40, 3, replace=False)))
        + "\n" for _ in range(rows))


def _zip(path, files: dict):
    with zipfile.ZipFile(path, "w") as z:
        for name, text in files.items():
            z.writestr(name, text)
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture()
def mirror(tmp_path):
    """A mirror directory: ml-100k (NCF, with a sha256 sidecar), frappe
    (libFM, no sidecar), an escaping zip and a corrupt one."""
    mdir = tmp_path / "mirror"
    mdir.mkdir()
    train, test = _ncf_files(0)
    digest = _zip(mdir / "ml-100k.zip", {"ml-100k/train.txt": train, "ml-100k/test.txt": test})
    (mdir / "ml-100k.zip.sha256").write_text(f"{digest}  ml-100k.zip\n")
    _zip(mdir / "frappe.zip", {"frappe/train.libfm": _libfm(1, 80),
                               "frappe/test.libfm": _libfm(2, 20)})
    _zip(mdir / "ml-1m.zip", {"ml-1m/train.txt": train, "../escaped.txt": "x"})
    _zip(mdir / "pinterest-20.zip", {"/abs/escaped.txt": "x"})
    _zip(mdir / "criteo.zip", {"criteo/train.libfm": "1 1:1\n", "criteo/test.libfm": "0 2:1\n"})
    (mdir / "criteo.zip.sha256").write_text("0" * 64 + "\n")
    return mdir


@pytest.fixture(params=["file", "http"])
def served(request, mirror):
    """The mirror's URL: ``file://`` or an HTTP server on 127.0.0.1."""
    if request.param == "file":
        yield mirror.as_uri()
        return
    handler = partial(http.server.SimpleHTTPRequestHandler, directory=str(mirror))
    handler.log_message = lambda *a, **k: None
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()
    httpd.server_close()


def _env(monkeypatch, url, cache):
    monkeypatch.setenv("GORSE_TPU_DATASET_MIRROR", url)
    monkeypatch.setenv("GORSE_TPU_DATASET_DIR", str(cache))


def _tree(path):
    return {str(p.relative_to(path)): p.read_bytes() for p in sorted(path.rglob("*"))
            if p.is_file()}


def test_locate_fetches_verifies_and_caches(served, tmp_path, monkeypatch):
    trees = {}
    for pkg, (R, _) in PACKAGES.items():
        cache = tmp_path / f"cache-{pkg}"
        _env(monkeypatch, served, cache)
        train_p, test_p = R.locate_built_in("ml-100k", "ncf")
        assert train_p == cache / "ml-100k" / "train.txt" and test_p.exists()
        assert R.built_in_available("ml-100k")
        # a partial cache (test file gone) repairs itself from the mirror
        test_p.unlink()
        assert R.locate_built_in("ml-100k", "ncf")[1].exists()
        R.locate_built_in("frappe", "libfm")
        trees[pkg] = _tree(cache)
    assert trees["port"] == trees["ref"] and "ml-100k/train.txt" in trees["port"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_refusals(pkg, served, tmp_path, monkeypatch):
    R = PACKAGES[pkg][0]
    cache = tmp_path / f"cache-{pkg}"
    _env(monkeypatch, served, cache)
    with pytest.raises(R.DatasetIntegrityError, match="sha256"):
        R.locate_built_in("criteo", "libfm")  # the sidecar disagrees
    monkeypatch.setitem(R.CHECKSUMS, "frappe", "f" * 64)
    with pytest.raises(R.DatasetIntegrityError, match="sha256"):
        R.locate_built_in("frappe", "libfm")  # a pinned checksum disagrees
    for name in ("ml-1m", "pinterest-20"):
        with pytest.raises(R.DatasetIntegrityError, match="escapes"):
            R.locate_built_in(name, "ncf")
    assert not (tmp_path / "escaped.txt").exists() and not (cache / "escaped.txt").exists()
    with pytest.raises(ValueError, match="format"):
        R.locate_built_in("ml-100k", "libfm")
    with pytest.raises(KeyError):
        R.locate_built_in("nope", "ncf")
    monkeypatch.delenv("GORSE_TPU_DATASET_MIRROR")
    assert not R.built_in_available("ml-100k")
    with pytest.raises(FileNotFoundError, match="GORSE_TPU_DATASET_MIRROR"):
        R.locate_built_in("ml-100k", "ncf")


def _raw_ratings(seed: int, sep: str, n_users: int = 9, per_user: int = 7) -> str:
    rng = np.random.default_rng(seed)
    lines = []
    for u in range(1, n_users + 1):
        for j, it in enumerate(rng.permutation(40)[:per_user]):
            ts = 1000 + int(rng.integers(0, 4))  # ties on purpose
            lines.append(sep.join([str(u), str(int(it) + 7), str(int(rng.integers(1, 6))),
                                   str(ts)]))
    lines.append(sep.join(["99", "3", "5", "1"]))  # a user with one rating
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("fmt", ["ratings.dat", "u.data"])
def test_convert_movielens_is_the_references(fmt, tmp_path):
    raw = tmp_path / fmt
    raw.write_text(_raw_ratings(3, "::" if fmt.endswith(".dat") else "\t"))
    outs = {}
    for pkg, (R, _) in PACKAGES.items():
        train_p, test_p = R.convert_movielens_ncf(raw, "ml-x", out_dir=tmp_path / pkg,
                                                  n_negatives=12, seed=4)
        outs[pkg] = (train_p.read_bytes(), test_p.read_bytes())
    assert outs["port"] == outs["ref"] and outs["port"][1].count(b"\n") == 9


def _dataset_state(d):
    return (d.user_dict.to_dict(), d.item_dict.to_dict(), d.user_feedback, d.item_feedback,
            d.timestamps, d.count_feedback(), getattr(d, "file_negatives", None))


def test_load_built_in_is_the_references(mirror, tmp_path, monkeypatch):
    got = {}
    for pkg, (_, L) in PACKAGES.items():
        _env(monkeypatch, mirror.as_uri(), tmp_path / f"cache-{pkg}")
        train, test = L.load_built_in("ml-100k")
        negs = test.sample_user_negatives(train, 10)
        got[pkg] = (_dataset_state(train), _dataset_state(test), negs.tolist())
        with pytest.raises(ValueError, match="load_built_in_ctr"):
            L.load_built_in("frappe")
        with pytest.raises(KeyError):
            L.load_built_in("nope")
    assert got["port"] == got["ref"]
    assert got["port"][1][-1] is not None and len(got["port"][2][0]) <= 4


def test_load_built_in_ctr_is_the_references(mirror, tmp_path, monkeypatch):
    got = {}
    for pkg, (_, L) in PACKAGES.items():
        _env(monkeypatch, mirror.as_uri(), tmp_path / f"cache-{pkg}")
        train, test = L.load_built_in_ctr("frappe")
        got[pkg] = [(d.features, d.targets, d.index.to_dict()) for d in (train, test)]
        with pytest.raises(KeyError):
            L.load_built_in_ctr("ml-100k")
    assert got["port"] == got["ref"] and len(got["port"][0][1]) == 80


def test_file_negatives_drive_the_evaluation(mirror, tmp_path, monkeypatch):
    """The port's evaluation candidates take the file's negatives, padded
    with -1 and masked, as the reference's do."""
    from gorse_tpu.models.base import build_eval_candidates as ref_build
    from gorse_tpu_torch.models.base import build_eval_candidates as port_build

    out = {}
    for pkg, build in (("ref", ref_build), ("port", port_build)):
        _env(monkeypatch, mirror.as_uri(), tmp_path / f"cache-{pkg}")
        train, test = PACKAGES[pkg][1].load_built_in("ml-100k")
        out[pkg] = [np.asarray(a).tolist() for a in build(test, train, 100)]
    assert out["port"] == out["ref"]


def test_bench_ctr_takes_a_registry_dataset(mirror, tmp_path, monkeypatch, capsys):
    import json

    from gorse_tpu_torch.cmd import bench

    _env(monkeypatch, mirror.as_uri(), tmp_path / "cache")
    assert bench.main(["ctr", "--dataset", "frappe", "--epochs", "2", "--verbose", "0",
                       "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["dataset"] == "frappe" and 0.0 <= out["AUC"] <= 1.0
