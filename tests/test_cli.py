"""End-to-end CLI integration tests (tiny data, CPU backend)."""

import os

import numpy as np
import pytest

from tpu_mf.cli import build_parser, main
from tpu_mf.data.coo import synthetic_ratings
from tpu_mf.data.proto import write_block_frames
from tpu_mf.io.checkpoint import load_mf_binary


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ds = synthetic_ratings(60, 40, 4000, rank=3, noise=0.1, seed=0)
    train, rest = ds.split(0.3, seed=1)
    valid, test = rest.split(0.5, seed=2)
    paths = {}
    for name, part in (("train", train), ("valid", valid), ("test", test)):
        p = str(d / f"{name}.pb")
        write_block_frames(p, part)
        paths[name] = p
    paths["gb"] = f"{ds.mean_rating():.6f}"
    paths["dir"] = str(d)
    return paths


def base_args(data, alg):
    return [
        "--alg", alg, "--train", data["train"], "--test", data["test"],
        "--dim", "4", "--iter", "2", "--bias", data["gb"],
        "--batch_size", "256", "--gam", "0.3",
    ]


def test_cli_mf_trains_and_checkpoints(data, capsys):
    result = os.path.join(data["dir"], "mf_model")
    rc = main(base_args(data, "mf") + ["--eta", "0.05", "--result", result])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("tRMSE=") == 2
    params, lam = load_mf_binary(result + "_2", gb=float(data["gb"]))
    assert params.theta.shape == (60, 4)

    # warm start from the checkpoint continues training
    rc = main(
        base_args(data, "mf") + ["--eta", "0.05", "--model", result + "_2"]
    )
    assert rc == 0


def test_cli_dpmf_trains(data, capsys):
    rc = main(
        base_args(data, "dpmf")
        + ["--eta", "1e-5", "--temp", "1e-6", "--hyperb", "1000"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("round #") == 2
    assert "nan" not in out


def test_cli_admf_trains(data, capsys):
    rc = main(
        base_args(data, "admf")
        + ["--valid", data["valid"], "--eta", "0.05", "--eta_reg", "1e-3"]
    )
    assert rc == 0
    assert capsys.readouterr().out.count("tRMSE=") == 2


def test_cli_admf_requires_valid(data, capsys):
    rc = main(base_args(data, "admf") + ["--eta", "0.05"])
    assert rc == 1


def test_cli_requires_train():
    assert main(["--alg", "mf"]) == 1


def test_cli_accepts_every_reference_flag():
    """Every flag of the reference's parser (main.cc:106-137) must parse."""
    argv = []
    for flag, val in [
        ("--train", "x"), ("--test", "x"), ("--valid", "x"), ("--result", "x"),
        ("--model", "x"), ("--alg", "mf"), ("--dim", "4"), ("--iter", "1"),
        ("--nu", "10"), ("--nv", "10"), ("--fly", "8"), ("--stride", "2"),
        ("--eta", "1e-2"), ("--lambda", "1e-3"), ("--gam", "1.0"),
        ("--bias", "2.76"), ("--mineta", "1e-13"), ("--epsilon", "0.1"),
        ("--tau", "10"), ("--hypera", "1.0"), ("--hyperb", "100.0"),
        ("--temp", "1.0"), ("--noise_size", "1000"), ("--eta_reg", "2e-3"),
        ("--loss", "0"), ("--measure", "0"),
    ]:
        argv += [flag, val]
    args = build_parser().parse_args(argv)
    assert args.lam == pytest.approx(1e-3)
    assert args.gb == pytest.approx(2.76)


def test_cli_mf_stream_mode(data, capsys):
    rc = main(base_args(data, "mf") + ["--eta", "0.03", "--stream"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("tRMSE=") == 2
    assert "nan" not in out

def _assert_refused_before_loading(argv, capsys, monkeypatch):
    """The mesh refusal comes at argument checking: no file is read."""
    import tpu_mf.data.textfmt as textfmt
    import tpu_mf.io.stream as stream

    def fail(*a, **k):
        raise AssertionError("data was loaded before the mesh refusal")

    monkeypatch.setattr(textfmt, "read_any", fail)
    monkeypatch.setattr(stream, "scan_dims", fail)
    assert main(argv) == 1
    err = capsys.readouterr().err
    assert "--mesh 2" in err and "drop --mesh" in err
    return err


def test_cli_stream_mesh_trains(data, capsys, monkeypatch):
    """--stream --mesh (mf) has no mesh implementation: refused up front
    instead of quietly training on one device."""
    err = _assert_refused_before_loading(
        base_args(data, "mf") + ["--eta", "0.03", "--stream", "--mesh", "2"],
        capsys, monkeypatch)
    assert "--stream" in err


def test_cli_stream_mesh_dpmf_trains(data, capsys, monkeypatch):
    """--stream --mesh dpmf: refused before the stream is scanned."""
    err = _assert_refused_before_loading(
        base_args(data, "dpmf")
        + ["--eta", "1e-5", "--temp", "1e-6", "--hyperb", "1000",
           "--stream", "--mesh", "2"],
        capsys, monkeypatch)
    assert "--stream" in err


def test_cli_stream_mesh_admf_trains(data, capsys, monkeypatch):
    """--stream --mesh admf: refused before the stream is scanned."""
    err = _assert_refused_before_loading(
        base_args(data, "admf")
        + ["--eta", "0.03", "--eta_reg", "0.05", "--valid", data["valid"],
           "--stream", "--mesh", "2"],
        capsys, monkeypatch)
    assert "--stream" in err


@pytest.mark.parametrize("alg", ["dpmf", "admf"])
@pytest.mark.parametrize("stream", [False, True])
def test_cli_mesh_refused_for_dpmf_admf(alg, stream, capsys, monkeypatch):
    """dpmf/admf have no mesh epoch: --mesh 2 fails before any file is
    opened (the paths below do not exist)."""
    argv = ["--alg", alg, "--train", "/nonexistent/train.pb",
            "--valid", "/nonexistent/valid.pb", "--mesh", "2"]
    err = _assert_refused_before_loading(
        argv + (["--stream"] if stream else []), capsys, monkeypatch)
    assert ("--stream" in err) if stream else (f"--alg {alg}" in err)


def test_cli_mesh_mf_trains(data, capsys):
    """In-memory --alg mf --mesh 2 is the supported mesh path."""
    rc = main(base_args(data, "mf") + ["--eta", "0.05", "--mesh", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("tRMSE=") == 2
    assert "nan" not in out


@pytest.mark.parametrize("alg,fn", [
    ("mf", "train_mf_stream"), ("dpmf", "train_dpmf_stream"),
    ("admf", "train_admf_stream"), ("dpmf", "train_dpmf"),
    ("admf", "train_admf"),
])
def test_library_trainers_refuse_unsupported_mesh(alg, fn, data):
    """The library entry points refuse the same mesh runs as the CLI."""
    from tpu_mf.config import TrainConfig
    from tpu_mf.data.textfmt import read_any
    import tpu_mf.train.loop as loop

    cfg = TrainConfig(alg=alg, dim=4, iters=1, mesh=2)
    ds = read_any(data["train"])
    args = {
        "train_mf_stream": (cfg, data["train"]),
        "train_dpmf_stream": (cfg, data["train"]),
        "train_admf_stream": (cfg, data["train"], ds),
        "train_dpmf": (cfg, ds),
        "train_admf": (cfg, ds, ds),
    }[fn]
    with pytest.raises(ValueError, match="--mesh 2"):
        getattr(loop, fn)(*args, log=lambda s: None)


def test_cli_stream_model_warm_start(data, capsys):
    """Warm start composed with streaming (reference: load-before-stream,
    main.cc:38): the second run resumes from the first run's checkpoint."""
    result = os.path.join(data["dir"], "mf_stream_ws")
    rc = main(base_args(data, "mf")
              + ["--eta", "0.05", "--stream", "--result", result])
    assert rc == 0
    first = capsys.readouterr().out
    rc = main(base_args(data, "mf")
              + ["--eta", "0.03", "--stream", "--model", result + "_2"])
    assert rc == 0
    second = capsys.readouterr().out

    def last_rmse(out):
        return float(out.strip().splitlines()[-1].split("tRMSE=")[1])

    # warm-started streaming run continues from (not above) the cold finish
    assert last_rmse(second) <= last_rmse(first) + 0.02


def test_cli_dpmf_stream_hyper_warm_start(data, capsys):
    from tpu_mf.io.checkpoint import load_dpmf_hyper

    result = os.path.join(data["dir"], "dpmf_stream_ws")
    rc = main(
        base_args(data, "dpmf")
        + ["--eta", "1e-5", "--temp", "1e-6", "--hyperb", "1000",
           "--result", result]
    )
    assert rc == 0
    capsys.readouterr()
    rc = main(
        base_args(data, "dpmf")
        + ["--eta", "1e-5", "--temp", "1e-6", "--hyperb", "1000",
           "--stream", "--model", result + "_2"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("round #") == 2
    assert "nan" not in out


def test_cli_dpmf_stream_mode(data, capsys):
    rc = main(
        base_args(data, "dpmf")
        + ["--eta", "1e-5", "--temp", "1e-6", "--hyperb", "1000", "--stream"]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("round #") == 2
    assert "nan" not in out


def test_cli_admf_stream_mode(data, capsys):
    rc = main(
        base_args(data, "admf")
        + ["--valid", data["valid"], "--eta", "0.05", "--eta_reg", "1e-3",
           "--stream"]
    )
    assert rc == 0
    assert capsys.readouterr().out.count("tRMSE=") == 2


def test_cli_stream_infers_dims_without_loading(data, capsys, monkeypatch):
    # The stream path must never materialize the training set in host RAM.
    import tpu_mf.data.textfmt as textfmt

    real = textfmt.read_any
    calls = []

    def spy(path, **kw):
        calls.append(path)
        return real(path, **kw)

    monkeypatch.setattr(textfmt, "read_any", spy)
    rc = main(base_args(data, "mf") + ["--eta", "0.03", "--stream"])
    assert rc == 0
    assert data["train"] not in calls  # only the test file was loaded
    assert capsys.readouterr().out.count("tRMSE=") == 2


def test_cli_metrics_jsonl(data, tmp_path):
    import json

    mpath = str(tmp_path / "m.jsonl")
    rc = main(base_args(data, "mf") + ["--eta", "0.05", "--metrics", mpath])
    assert rc == 0
    lines = [json.loads(l) for l in open(mpath)]
    assert len(lines) == 2
    assert lines[0]["alg"] == "mf" and lines[0]["round"] == 1
    assert lines[1]["updates_per_sec"] > 0
    assert "tRMSE" in lines[0] and np.isfinite(lines[0]["tRMSE"])


def test_cli_resume_restart_continues(data, tmp_path, capsys):
    """Killed-and-restarted run continues from the last round checkpoint."""
    result = str(tmp_path / "resmf")
    args = base_args(data, "mf") + ["--eta", "0.05", "--result", result, "--resume"]
    # First run: 2 rounds -> checkpoints r1, r2.
    assert main(args) == 0
    capsys.readouterr()
    # "Restart" with more iters: must resume at round 3, not round 1.
    # (base_args sets --iter 2; the trailing flag wins in argparse.)
    assert main(args + ["--iter", "4"]) == 0
    out = capsys.readouterr().out
    assert "# resumed from round 2" in out
    assert "iter#3" in out and "iter#4" in out
    assert "iter#1\t" not in out


def test_cli_resume_requires_result(data, capsys):
    rc = main(base_args(data, "mf") + ["--eta", "0.05", "--resume"])
    assert rc == 1
    assert "--result" in capsys.readouterr().err


def test_cli_resume_dpmf_roundtrips_hyper(data, tmp_path, capsys):
    result = str(tmp_path / "resdp")
    args = base_args(data, "dpmf") + [
        "--eta", "1e-5", "--temp", "1e-6", "--hyperb", "1000",
        "--result", result, "--resume",
    ]
    assert main(args) == 0
    capsys.readouterr()
    assert main(args + ["--iter", "3"]) == 0
    out = capsys.readouterr().out
    assert "# resumed from round 2" in out
    assert "round #3" in out and "round #1" not in out


def test_cli_measure_ranking(data, capsys):
    rc = main(base_args(data, "mf") + ["--eta", "0.05", "--measure", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "recall@10=" in out and "ndcg@10=" in out
