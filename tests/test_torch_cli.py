"""The port's admin CLI and bench (gorse_tpu_torch/cmd/cli.py, cmd/bench.py)
held against gorse_tpu's (tests/test_cli.py):

- both CLIs against an in-one node of each package (the port's on
  ``device="cpu"``, built as tests/test_cli.py builds the reference's):
  the two CLIs print the same bytes against the same node, and the two
  nodes give the same answers where the answer does not depend on the
  trained model (users, categories, the pipeline config and its schema);
  recommendation lists only in length;
- ``_json_patch`` and the named contexts, case by case, equal;
- the bench on the CPU: ``cf`` (bpr, als) and ``ctr`` fit from the same
  synthetic data as the reference's bench, their metrics within stated
  tolerances (the two packages' generators draw different initial factors
  and samples, so only the quality is comparable: NDCG@10 within 0.1 of
  the reference's, AUC within 0.1); ``embedding`` against the mock server
  equal to the reference's exactly (hash embeddings, exact neighbours);
  ``retrieval`` on both routes; ``reranker`` against the mock equal to the
  reference's exactly (the same prompts, the same echo);
- the port's ``dump``, ``restore`` and ``export`` against the port's
  master: a dump restored into a second node gives the same rows and dumps
  to the same bytes, and the CSV exports equal the reference CLI's against
  the reference's node.
"""

import json
import socket

import numpy as np
import pytest

from gorse_tpu.cmd import bench as ref_bench
from gorse_tpu.cmd import cli as ref_cli
from gorse_tpu_torch.cmd import bench as port_bench
from gorse_tpu_torch.cmd import cli as port_cli

CLIS = {"ref": ref_cli, "port": port_cli}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _node(name, workdir):
    if name == "ref":
        from gorse_tpu.serve import InOneNode
        from gorse_tpu.storage import Feedback, Item
        from gorse_tpu.utils.config import Config
        kw = {}
    else:
        from gorse_tpu_torch.serve.in_one import InOneNode
        from gorse_tpu_torch.storage.types import Feedback, Item
        from gorse_tpu_torch.utils.config import Config
        kw = {"device": "cpu"}
    config = Config()
    config.recommend.collaborative.type = "mf"
    config.recommend.ranker.type = "none"
    node = InOneNode(config, workdir=str(workdir), **kw)
    rng = np.random.default_rng(0)
    node.data.insert_items([Item(f"i{k}", timestamp=float(k), categories=["c"])
                            for k in range(12)])
    pairs = [(u, i) for u in range(6) for i in range(12)]
    rng.shuffle(pairs)
    node.data.insert_feedback([
        Feedback("like", f"u{u}", f"i{i}", timestamp=float(t))
        for t, (u, i) in enumerate(pairs[:40])
    ])
    node.run_once()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    node.serve("127.0.0.1", port, background_loop=False)
    return node, f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    out = {name: _node(name, tmp_path_factory.mktemp(f"cli-{name}")) for name in CLIS}
    yield {name: base for name, (_, base) in out.items()}
    for node, _ in out.values():
        node.shutdown()


def _run(capsys, cli, base, *argv) -> str:
    assert cli.main(["--url", base, *argv]) == 0
    return capsys.readouterr().out


READS = [
    ("get", "user", "u1"), ("get", "users", "-n", "3"), ("get", "categories"),
    ("get", "item", "i3"), ("pipeline", "show"), ("pipeline", "schema"),
]


@pytest.mark.parametrize("argv", READS, ids=["-".join(a) for a in READS])
def test_cli_reads_match(nodes, capsys, argv):
    """Both CLIs print the same bytes against each node; the nodes agree."""
    outs = {}
    for node_name, base in nodes.items():
        printed = {name: _run(capsys, cli, base, *argv) for name, cli in CLIS.items()}
        assert printed["port"] == printed["ref"], node_name
        outs[node_name] = json.loads(printed["port"])
    assert outs["port"] == outs["ref"]


@pytest.mark.parametrize("argv,n", [(("recommend", "u1", "-n", "5"), 5),
                                    (("item-to-user", "u1", "collaborative", "-n", "3"), 3),
                                    (("stats",), None)])
def test_cli_model_answers(nodes, capsys, argv, n):
    """Answers that depend on the trained model: the same length from both
    nodes, through both CLIs alike."""
    outs = {}
    for node_name, base in nodes.items():
        printed = {name: _run(capsys, cli, base, *argv) for name, cli in CLIS.items()}
        if argv[0] != "stats":
            assert printed["port"] == printed["ref"]
        outs[node_name] = json.loads(printed["port"])
    if n is None:
        assert set(outs["port"]) == set(outs["ref"])
    else:
        assert len(outs["port"]) == len(outs["ref"]) == n


def test_cli_dump_restore_export(nodes, capsys, tmp_path):
    """The port's ``dump``, ``restore`` and ``export`` against the port's
    master (routes that answered 404 before): the dump equals the reference
    CLI's dump of the reference's node byte for byte; restored into an
    empty port node it gives the same rows, which dump to the same bytes;
    each CSV export equals the reference's and the restored node's."""
    from gorse_tpu_torch.serve.in_one import InOneNode
    from gorse_tpu_torch.utils.config import Config

    dumps = {}
    for name, cli in CLIS.items():
        dumps[name] = tmp_path / f"{name}.dump"
        assert "dumped to" in _run(capsys, cli, nodes[name], "dump", str(dumps[name]))
    first = dumps["port"].read_bytes()
    assert first.startswith(b"GTPU1") and first == dumps["ref"].read_bytes()
    config = Config()
    config.recommend.collaborative.type = "mf"
    fresh = InOneNode(config, workdir=str(tmp_path / "fresh"), device="cpu")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    fresh.serve("127.0.0.1", port, background_loop=False)
    fresh_base = f"http://127.0.0.1:{port}"
    try:
        counts = json.loads(_run(capsys, port_cli, fresh_base, "restore", str(dumps["port"])))
        assert counts == {"users": 6, "items": 12, "feedback": 40}
        again = tmp_path / "again.dump"
        _run(capsys, port_cli, fresh_base, "dump", str(again))
        assert again.read_bytes() == first
        for what in ("users", "items", "feedback"):
            paths = {}
            for name, base in (("port", nodes["port"]), ("ref", nodes["ref"]),
                               ("fresh", fresh_base)):
                paths[name] = tmp_path / f"{name}-{what}.csv"
                cli = CLIS["ref"] if name == "ref" else port_cli
                assert "exported to" in _run(capsys, cli, base, "export", what, str(paths[name]))
            got = paths["port"].read_bytes()
            assert got.count(b"\n") > 1 and got == paths["ref"].read_bytes() \
                == paths["fresh"].read_bytes(), what
    finally:
        fresh.shutdown()


def test_cli_pipeline_patch_and_reset(nodes, capsys):
    """tests/test_cli.py:74 through the port's CLI against each node: patch,
    show, reset, show; the nodes show the same sizes at every step."""
    sizes = {}
    for name, base in nodes.items():
        cfg = json.loads(_run(capsys, port_cli, base, "pipeline", "show"))
        old = cfg["recommend"]["cache_size"]
        _run(capsys, port_cli, base, "pipeline", "patch",
             json.dumps([{"op": "replace", "path": "/cache_size", "value": old + 7}]))
        cfg2 = json.loads(_run(capsys, port_cli, base, "pipeline", "show"))
        assert cfg2["recommend"]["cache_size"] == old + 7
        _run(capsys, port_cli, base, "pipeline", "reset", "-y")
        cfg3 = json.loads(_run(capsys, port_cli, base, "pipeline", "show"))
        sizes[name] = (old, cfg2["recommend"]["cache_size"], cfg3["recommend"]["cache_size"])
    assert sizes["port"] == sizes["ref"]


@pytest.mark.parametrize("patch", [
    [{"op": "replace", "path": "/cache_size", "value": 500}],
    [{"op": "replace", "path": "/data_source/item_ttl", "value": 72}],
    [{"op": "remove", "path": "/xs/1"}, {"op": "add", "path": "/extra", "value": "x"}],
    [{"op": "add", "path": "/xs/-", "value": 9}],
    [{"op": "add", "path": "/a~1b", "value": 1}],
    [{"op": "test", "path": "/a", "value": 1}],
    [{"op": "remove", "path": "/missing"}],
])
def test_json_patch_matches(patch):
    def run(mod):
        doc = {"cache_size": 100, "data_source": {"item_ttl": 0}, "xs": [1, 2, 3]}
        try:
            return mod._json_patch(doc, patch), None
        except Exception as e:  # compared across packages
            return None, type(e).__name__

    assert run(port_cli) == run(ref_cli)


def test_cli_contexts_match(tmp_path, capsys, monkeypatch):
    """tests/test_cli.py:110's context commands, through each CLI on a store
    of its own: the same exit codes, output and endpoint resolution."""
    monkeypatch.delenv("GORSE_ADMIN_ENDPOINT", raising=False)
    monkeypatch.delenv("GORSE_ADMIN_API_KEY", raising=False)
    steps = [
        ["context", "list"], ["context", "add", "prod", "--endpoint", "http://prod:8087",
                              "--key", "k1"],
        ["context", "add", "dev", "--endpoint", "http://dev:8087", "--key", "k2"],
        ["context", "current"], ["context", "use", "prod"], ["context", "list"],
        ["context", "delete", "prod"], ["context", "current"], ["context", "use", "ghost"],
        ["context", "add", "bad name", "--endpoint", "x", "--no-prompt"],
        ["context", "delete", "dev"], ["context", "current"],
    ]
    logs = {}
    for name, cli in CLIS.items():
        monkeypatch.setenv("GORSE_CLI_CONTEXTS", str(tmp_path / f"{name}.json"))
        log = []
        for argv in steps:
            rc = cli.main(list(argv))
            log.append((rc, capsys.readouterr().out))
            if argv[:2] == ["context", "add"] and rc == 0:

                class A:
                    url, api_key, context = "", "", ""
                log.append(cli._resolve_endpoint(A()))
        logs[name] = log
    assert logs["port"] == logs["ref"]


@pytest.fixture(scope="module")
def cf_runs():
    """``bench cf`` of both packages, bpr and als, on the same synthetic
    dataset (printed JSON)."""
    out = {}
    for model in ("bpr", "als"):
        argv = ["cf", "--model", model, "--dataset", "synthetic://300,200,8,0.08,0",
                "--epochs", "20", "--verbose", "20"]
        out[model] = {}
        for name, mod, extra in (("ref", ref_bench, []), ("port", port_bench,
                                                          ["--device", "cpu"])):
            out[model][name] = _bench(mod, argv + extra)
    return out


def _bench(mod, argv):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


CF_NDCG_TOL = 0.1  # different init factors and samples: quality, not bits


@pytest.mark.parametrize("model", ["bpr", "als"])
def test_bench_cf_matches_reference(cf_runs, model):
    ref, port = cf_runs[model]["ref"], cf_runs[model]["port"]
    assert set(port) == set(ref) | {"device"} and port["device"] == "cpu"
    assert port["model"] == ref["model"] and port["examples"] == ref["examples"]
    assert abs(port["NDCG@10"] - ref["NDCG@10"]) <= CF_NDCG_TOL, (port, ref)
    assert port["NDCG@10"] > 0.1


def test_bench_ctr_matches_reference():
    argv = ["ctr", "--samples", "2000", "--epochs", "10", "--verbose", "10"]
    ref = _bench(ref_bench, argv)
    port = _bench(port_bench, argv + ["--device", "cpu"])
    assert set(port) == set(ref) | {"device"}
    assert abs(port["AUC"] - ref["AUC"]) <= 0.1, (port, ref)


def test_bench_embedding_matches_reference():
    argv = ["embedding", "--dataset", "synthetic://60,40,4,0.1,0", "--k", "3", "--dim", "16"]
    ref = _bench(ref_bench, argv)
    port = _bench(port_bench, argv + ["--device", "cpu"])
    assert port.pop("device") == "cpu"
    assert port == ref and port["items"] == 40


@pytest.mark.parametrize("kernel", ["pallas", "xla"])
def test_bench_retrieval_runs(kernel):
    out = _bench(port_bench, ["retrieval", "--kernel", kernel, "--items", "3000",
                              "--batch", "16", "--batches", "2", "--device", "cpu"])
    assert out["kernel"] == kernel and out["timer"] == "host_clock"
    assert out["queries_per_s"] > 0 and out["dtype"] == ("bf16" if kernel == "pallas" else "f32")


def test_bench_reranker_names_m21():
    """``bench reranker`` (once raising, naming M21) prints the reference's
    result: the same users, candidates and prompts against the echoing
    mock."""
    argv = ["reranker", "--users", "8", "--candidates", "6"]
    assert _bench(port_bench, argv) == _bench(ref_bench, argv)


def test_bench_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_bench.main(["retrieval", "--items", "300", "--batches", "1"])
