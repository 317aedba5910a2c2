"""Built-in dataset registry: locate, fetch, verify, unzip, convert (copy
of gorse_tpu/data/registry.py).

gorse's model/built_in.go (the registry :46-83, LocateBuiltInDataset
:113-130, download and unzip :133-204) fetches from cdn.gorse.io. Here the
fetch layer resolves each dataset zip against a MIRROR named by the
environment, into the dataset directory (``GORSE_TPU_DATASET_DIR``,
default ``~/.gorse_tpu/datasets``, the reference package's):

- ``GORSE_TPU_DATASET_MIRROR=file:///mnt/datasets``: a local directory
  holding ``<name>.zip`` files;
- ``GORSE_TPU_DATASET_MIRROR=http://host/datasets``: an HTTP mirror.

Integrity: each zip is sha256-verified before extraction when a checksum is
known — from :data:`CHECKSUMS` or a ``<name>.zip.sha256`` sidecar file next
to the zip in the mirror (the reference trusts the CDN; we verify because a
file:// mirror is user-provided). Extraction refuses path traversal.

Converters: :func:`convert_movielens_ncf` builds the gorse NCF layout
(``train.txt`` + leave-one-out ``test.txt`` with 99 sampled negatives,
dataset/dataset.go:426-493 format) straight from raw MovieLens exports
(ml-100k ``u.data``, ml-1m ``ratings.dat``), so parity runs don't require
gorse's preprocessed zips — any stock MovieLens download works.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import urllib.parse
import urllib.request
import zipfile
from pathlib import Path

import numpy as np

# name -> (train file, test file, format). Mirrors model/built_in.go:46-83.
BUILT_IN_FILES: dict[str, tuple[str, str, str]] = {
    "pinterest-20": ("pinterest-20/train.txt", "pinterest-20/test.txt", "ncf"),
    "ml-100k": ("ml-100k/train.txt", "ml-100k/test.txt", "ncf"),
    "ml-1m": ("ml-1m/train.txt", "ml-1m/test.txt", "ncf"),
    "ml-tag": ("ml-tag/train.libfm", "ml-tag/test.libfm", "libfm"),
    "frappe": ("frappe/train.libfm", "frappe/test.libfm", "libfm"),
    "criteo": ("criteo/train.libfm", "criteo/test.libfm", "libfm"),
}

# sha256 of <name>.zip when known. None = not pinned (accept any, or verify
# against a .sha256 sidecar if the mirror provides one). The reference CDN
# publishes no checksums; pin values here once a trusted copy is obtained.
CHECKSUMS: dict[str, str | None] = {name: None for name in BUILT_IN_FILES}


def dataset_dir() -> Path:
    return Path(
        os.environ.get("GORSE_TPU_DATASET_DIR", "~/.gorse_tpu/datasets")
    ).expanduser()


def mirror_url() -> str | None:
    return os.environ.get("GORSE_TPU_DATASET_MIRROR")


class DatasetIntegrityError(RuntimeError):
    pass


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fetch(url: str, dst: Path) -> None:
    """Copy/download ``url`` to ``dst``. file:// is a plain copy; http(s)
    goes through urllib (only functional when the deployment has egress)."""
    parsed = urllib.parse.urlparse(url)
    dst.parent.mkdir(parents=True, exist_ok=True)
    if parsed.scheme == "file":
        src = Path(urllib.parse.unquote(parsed.path))
        if not src.exists():
            raise FileNotFoundError(f"mirror file {src} not found")
        shutil.copyfile(src, dst)
    elif parsed.scheme in ("http", "https"):
        with urllib.request.urlopen(url, timeout=60) as r, open(dst, "wb") as f:
            shutil.copyfileobj(r, f)
    else:
        raise ValueError(f"unsupported mirror scheme {parsed.scheme!r} in {url}")


def _expected_checksum(name: str, zip_path: Path, mirror: str) -> str | None:
    if CHECKSUMS.get(name):
        return CHECKSUMS[name]
    # Optional sidecar: <name>.zip.sha256 next to the zip in the mirror.
    # TRUST LIMITATION: for http(s) mirrors the sidecar comes
    # from the SAME origin as the zip, so this verifies transport integrity
    # only — a tampered mirror can rewrite both. Pin the digest in
    # CHECKSUMS (or ship it with a file:// mirror) for tamper resistance.
    sidecar = zip_path.with_name(zip_path.name + ".sha256")
    try:
        _fetch(f"{mirror.rstrip('/')}/{name}.zip.sha256", sidecar)
        return sidecar.read_text().split()[0].strip().lower()
    except Exception:
        return None


def _unzip(zip_path: Path, dst: Path) -> list[str]:
    """Extract with a path-traversal guard (unlike bare extractall)."""
    names = []
    with zipfile.ZipFile(zip_path) as z:
        for info in z.infolist():
            target = (dst / info.filename).resolve()
            if not str(target).startswith(str(dst.resolve()) + os.sep):
                raise DatasetIntegrityError(
                    f"zip entry {info.filename!r} escapes {dst}"
                )
        z.extractall(dst)
        names = z.namelist()
    return names


def fetch_built_in(name: str) -> None:
    """Download+verify+extract ``<name>.zip`` from the mirror into the
    dataset cache (the built_in.go:120-127 download-if-absent path)."""
    mirror = mirror_url()
    if not mirror:
        raise FileNotFoundError(
            f"dataset {name!r} not cached and no GORSE_TPU_DATASET_MIRROR set "
            f"(no network egress; set a file:// mirror or place files under "
            f"{dataset_dir()})"
        )
    with tempfile.TemporaryDirectory() as tmp:
        zip_path = Path(tmp) / f"{name}.zip"
        _fetch(f"{mirror.rstrip('/')}/{name}.zip", zip_path)
        expected = _expected_checksum(name, zip_path, mirror)
        if expected is not None:
            actual = _sha256(zip_path)
            if actual != expected:
                raise DatasetIntegrityError(
                    f"{name}.zip sha256 mismatch: expected {expected}, got {actual}"
                )
        _unzip(zip_path, dataset_dir())


def locate_built_in(name: str, fmt: str) -> tuple[Path, Path]:
    """Return (train_path, test_path) for a built-in dataset, fetching from
    the mirror on first use (model/built_in.go:113-130)."""
    if name not in BUILT_IN_FILES:
        raise KeyError(f"no such dataset {name!r}")
    train_rel, test_rel, actual_fmt = BUILT_IN_FILES[name]
    if actual_fmt != fmt:
        raise ValueError(f"dataset {name!r} format is {actual_fmt}, not {fmt}")
    train_p = dataset_dir() / train_rel
    test_p = dataset_dir() / test_rel
    # refetch when EITHER file is absent — a partially-extracted cache
    # (train present, test missing) must repair itself
    if not train_p.exists() or not test_p.exists():
        fetch_built_in(name)
    if not train_p.exists() or not test_p.exists():
        raise FileNotFoundError(
            f"dataset {name!r}: {train_p} / {test_p} missing after fetch"
        )
    return train_p, test_p


def built_in_available(name: str) -> bool:
    """True when the dataset is cached locally or fetchable from a mirror —
    the activation predicate for the real-data parity gates."""
    if name not in BUILT_IN_FILES:
        return False
    train_rel, _, _ = BUILT_IN_FILES[name]
    if (dataset_dir() / train_rel).exists():
        return True
    mirror = mirror_url()
    if not mirror:
        return False
    parsed = urllib.parse.urlparse(mirror)
    if parsed.scheme == "file":
        return (Path(urllib.parse.unquote(parsed.path)) / f"{name}.zip").exists()
    return True  # http mirror configured: assume reachable, fail loudly later


# ------------------------------------------------------------ converters


def convert_movielens_ncf(
    raw_path: str | Path,
    name: str = "ml-1m",
    out_dir: str | Path | None = None,
    n_negatives: int = 99,
    seed: int = 0,
) -> tuple[Path, Path]:
    """Convert a raw MovieLens ratings export to the gorse NCF layout.

    Accepts ml-1m ``ratings.dat`` (``user::item::rating::ts``) or ml-100k
    ``u.data`` (``user<TAB>item<TAB>rating<TAB>ts``). Produces the exact
    train/test format the reference loader parses
    (dataset/dataset.go:426-493): entities re-indexed to dense 0-based ints;
    each user's LAST-timestamped interaction held out as the test positive
    with ``n_negatives`` sampled non-interacted items (the NCF leave-one-out
    protocol gorse's preprocessed zips follow); everything else in
    ``train.txt`` as ``user<TAB>item`` lines.
    """
    raw_path = Path(raw_path)
    out = Path(out_dir) if out_dir else dataset_dir() / name
    out.mkdir(parents=True, exist_ok=True)
    sep = "::" if raw_path.suffix == ".dat" else "\t"
    users: dict[str, int] = {}
    items: dict[str, int] = {}
    # per-user [(ts, item_idx)] in file order
    feedback: list[list[tuple[float, int]]] = []
    with open(raw_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            fields = line.split(sep)
            u_raw, i_raw, ts = fields[0], fields[1], float(fields[3])
            u = users.setdefault(u_raw, len(users))
            i = items.setdefault(i_raw, len(items))
            while len(feedback) <= u:
                feedback.append([])
            feedback[u].append((ts, i))
    n_items = len(items)
    rng = np.random.default_rng(seed)
    with open(out / "train.txt", "w") as ftr, open(out / "test.txt", "w") as fte:
        for u, fb in enumerate(feedback):
            if len(fb) < 2:
                for _, i in fb:
                    ftr.write(f"{u}\t{i}\n")
                continue
            # hold out the latest interaction (stable on ts ties: last wins)
            test_pos = max(range(len(fb)), key=lambda j: (fb[j][0], j))
            positives = {i for _, i in fb}
            for j, (_, i) in enumerate(fb):
                if j != test_pos:
                    ftr.write(f"{u}\t{i}\n")
            negs: list[int] = []
            seen = set(positives)
            while len(negs) < min(n_negatives, n_items - len(positives)):
                c = int(rng.integers(n_items))
                if c not in seen:
                    seen.add(c)
                    negs.append(c)
            fte.write(
                f"({u},{fb[test_pos][1]})\t" + "\t".join(str(n) for n in negs) + "\n"
            )
    return out / "train.txt", out / "test.txt"
