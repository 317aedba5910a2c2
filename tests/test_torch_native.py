"""The port's native host library (gorse_tpu_torch/native/__init__.py over
fastdata.cpp) against gorse_tpu's: the libFM and NCF parsers and the CSR
build give the reference's arrays exactly, on the same inputs made from a
seed with numpy, natively and with the fallback forced; ``load_libfm_file``
(data/ctr.py) gives the reference's dataset either way. The build lands in
the checkout's ``build/gorse_tpu_torch/``, never the reference's
directory. Needs ``g++``.

The reference builds into one shared directory through a fixed temporary
name, so test workers that build at once can lose the race: such a worker
keeps ``_lib = None`` with ``_tried`` set and parses nothing natively.
``reference_native`` (autouse here and in tests/test_torch_hnsw.py) loads
the reference's library again before each comparison: the winner's file,
else a build in a directory of the worker's own."""

import os

import numpy as np
import pytest

import gorse_tpu.data.ctr as ref_ctr
import gorse_tpu.native as RN
import gorse_tpu.native.hnsw as RH
import gorse_tpu_torch.data.ctr as port_ctr
import gorse_tpu_torch.native as PN

# each reference library: its module and its loader
REFERENCE_LIBS = {"fastdata": (RN, RN.load_native), "hnsw": (RH, RH._load)}


def load_reference(name: str, own_dir) -> None:
    """Give the reference's ``name`` library (``REFERENCE_LIBS``) a loaded
    ``_lib``: as it is, else loaded again from the reference's directory
    (the file a winning worker built), else built into ``own_dir``
    (``GORSE_TPU_NATIVE_DIR`` for that load only)."""
    mod, load = REFERENCE_LIBS[name]
    if mod._lib is not None:
        return
    mod._tried = False
    if load() is None:
        before = os.environ.get("GORSE_TPU_NATIVE_DIR")
        os.environ["GORSE_TPU_NATIVE_DIR"] = str(own_dir)
        try:
            mod._tried = False
            load()
        finally:
            if before is None:
                del os.environ["GORSE_TPU_NATIVE_DIR"]
            else:
                os.environ["GORSE_TPU_NATIVE_DIR"] = before
    assert mod._lib is not None, f"g++ must build the reference's {name}"


@pytest.fixture(autouse=True)
def reference_native(tmp_path_factory):
    for name in REFERENCE_LIBS:
        load_reference(name, tmp_path_factory.getbasetemp() / "reference_native")


def _libfm_text(seed: int, rows: int = 400) -> bytes:
    """libFM rows: targets -1/0/1, sorted and unsorted features, bare
    indices, float values in several forms, blank lines and junk tokens."""
    rng = np.random.default_rng(seed)
    lines = []
    for r in range(rows):
        t = int(rng.choice([-1, 0, 1]))
        feats = rng.choice(5000, size=int(rng.integers(0, 9)), replace=False)
        toks = []
        for k in feats:
            form = int(rng.integers(4))
            v = float(rng.uniform(-3, 3))
            toks.append(str(k) if form == 0 else f"{k}:{v:.4f}" if form == 1
                        else f"{k}:{v:.6e}" if form == 2 else f"{k}:{int(v)}")
        if r % 97 == 5:
            toks.append("junk:1")
        lines.append(" ".join([str(t)] + toks))
        if r % 53 == 7:
            lines.append("")
    return ("\n".join(lines) + "\n").encode()


def _ncf_text(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(300):
        u, i = rng.integers(0, 10_000, 2)
        form = int(rng.integers(3))
        lines.append(f"{u}\t{i}\t1" if form == 0 else f"{u}\t{i}" if form == 1 else f"({u},{i})\t1")
    return ("\n".join(lines) + "\n").encode()


@pytest.fixture
def forced_fallback(monkeypatch):
    """Both packages as if ``g++`` had failed."""
    for mod in (PN, RN):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)


def _equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w


def test_the_library_builds_into_the_checkout():
    assert PN.load_native() is not None, "g++ must build native/fastdata.cpp"
    built = list(PN.BUILD_DIR.glob("fastdata-*.so"))
    assert built and all(p.parent.name == "gorse_tpu_torch" for p in built)
    assert PN.BUILD_DIR.parent.name == "build"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_libfm_parse_is_the_reference(seed):
    buf = _libfm_text(seed)
    _equal(PN.parse_libfm_bytes(buf), RN.parse_libfm_bytes(buf))


@pytest.mark.parametrize("seed", [0, 1])
def test_ncf_parse_is_the_reference(seed):
    buf = _ncf_text(seed)
    _equal(PN.parse_ncf_bytes(buf), RN.parse_ncf_bytes(buf))


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_build_csr_is_the_reference(seed, fallback, request):
    if fallback:
        request.getfixturevalue("forced_fallback")
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 60, size=3000).astype(np.int32)
    cols = rng.integers(0, 90, size=3000).astype(np.int32)
    _equal(PN.build_csr(rows, cols, 64), RN.build_csr(rows, cols, 64))


def test_forced_fallback_parses_nothing_natively(forced_fallback):
    assert PN.parse_libfm_bytes(b"1 2:3\n") is None and PN.parse_ncf_bytes(b"1\t2\n") is None


def _dataset(d) -> tuple:
    return (len(d.index), [list(map(list, f)) for f in d.features], list(d.targets))


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_load_libfm_file_is_the_reference(tmp_path, seed, fallback, request):
    """Without junk tokens (the Python parser raises on them, the native one
    skips them, in both packages), the native and the fallback datasets are
    the reference's."""
    if fallback:
        request.getfixturevalue("forced_fallback")
    buf = b"\n".join(line for line in _libfm_text(seed).split(b"\n") if b"junk" not in line)
    path = tmp_path / "train.libfm"
    path.write_bytes(buf)
    got = _dataset(port_ctr.load_libfm_file(str(path)))
    assert got == _dataset(ref_ctr.load_libfm_file(str(path)))
    assert len(got[2]) == sum(1 for line in buf.split(b"\n") if line.strip())


def test_native_and_fallback_datasets_agree(tmp_path, monkeypatch):
    """The port's native parse and its Python parse give one dataset (values
    through f32 on the native side, so they agree to f32)."""
    buf = b"\n".join(line for line in _libfm_text(5).split(b"\n") if b"junk" not in line)
    path = tmp_path / "train.libfm"
    path.write_bytes(buf)
    native = _dataset(port_ctr.load_libfm_file(str(path)))
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_tried", True)
    python = _dataset(port_ctr.load_libfm_file(str(path)))
    assert native[0] == python[0] and native[2] == python[2]
    for (ni, nv), (pi, pv) in zip(native[1], python[1]):
        assert ni == pi
        np.testing.assert_array_equal(np.float32(nv), np.float32(pv))


@pytest.mark.parametrize("shared", ["built", "corrupt"])
def test_a_worker_that_lost_the_reference_build_compares_natively(
        tmp_path, monkeypatch, shared):
    """Both reference libraries in a losing worker's state (``_lib = None``,
    ``_tried`` set: it loads nothing more by itself), with the reference's
    directory holding the winner's files or files cut short: after
    ``load_reference`` the comparisons run the native code on both sides,
    libFM, NCF and HNSW alike."""
    if shared == "corrupt":
        import hashlib

        shared_dir = tmp_path / "shared"
        shared_dir.mkdir()
        for name, (mod, _) in REFERENCE_LIBS.items():
            tag = hashlib.md5(mod._SRC.read_bytes()).hexdigest()[:12]
            (shared_dir / f"{name}_{tag}.so").write_bytes(b"\x7fELF cut short")
        monkeypatch.setenv("GORSE_TPU_NATIVE_DIR", str(shared_dir))
    for name, (mod, load) in REFERENCE_LIBS.items():
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
        assert load() is None
        load_reference(name, tmp_path / "own")
        assert mod._lib is not None
    for buf, parse in ((_libfm_text(4), "parse_libfm_bytes"), (_ncf_text(4), "parse_ncf_bytes")):
        want = getattr(RN, parse)(buf)
        assert want is not None
        _equal(getattr(PN, parse)(buf), want)
    import gorse_tpu_torch.native.hnsw as PH

    rng = np.random.default_rng(4)
    vecs, queries = rng.normal(size=(500, 8)).astype(np.float32), rng.normal(size=(5, 8))
    found = []
    for mod in (PH, RH):
        ix = mod.HNSWIndex(8, space="l2", seed=1)
        assert ix._lib is not None
        ix.add(np.arange(500, dtype=np.int64), vecs)
        found.append(ix.search(queries.astype(np.float32), 5, ef=20))
    assert np.array_equal(found[0][0], found[1][0]) and np.array_equal(found[0][1], found[1][1])
