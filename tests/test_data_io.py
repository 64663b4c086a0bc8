"""Data format and checkpoint roundtrip tests (SURVEY §4 test strategy)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tpu_mf.data.coo import RatingsCOO, synthetic_ratings
from tpu_mf.data import textfmt, proto
from tpu_mf.io import checkpoint as ckpt
from tpu_mf.models.mf import init_mf
import jax


def small_ds(seed=0, n=500, nu=50, nv=30):
    return synthetic_ratings(nu, nv, n, seed=seed)


def assert_same_ratings(a: RatingsCOO, b: RatingsCOO):
    """Equality as rating multisets (order may differ across formats)."""
    ka = np.lexsort((a.r, a.v, a.u))
    kb = np.lexsort((b.r, b.v, b.u))
    np.testing.assert_array_equal(a.u[ka], b.u[kb])
    np.testing.assert_array_equal(a.v[ka], b.v[kb])
    np.testing.assert_allclose(a.r[ka], b.r[kb], rtol=1e-6)


def test_raw_roundtrip(tmp_path):
    ds = small_ds()
    p = str(tmp_path / "ratings.txt")
    textfmt.write_raw(p, ds)
    back = textfmt.read_raw(p, nu=ds.nu, nv=ds.nv)
    assert_same_ratings(ds, back)
    assert textfmt.detect_format(p) == "raw"


def test_userwise_roundtrip(tmp_path):
    ds = small_ds()
    p = str(tmp_path / "userwise.txt")
    textfmt.write_userwise(p, ds)
    back = textfmt.read_userwise(p, nu=ds.nu, nv=ds.nv)
    assert_same_ratings(ds, back)
    assert textfmt.detect_format(p) == "userwise"


def test_movielens_read(tmp_path):
    p = str(tmp_path / "u.data")
    with open(p, "w") as f:
        f.write("1\t5\t3.0\t881250949\n2\t3\t4.5\t881250950\n")
    ds = textfmt.read_movielens(p)
    assert ds.u.tolist() == [0, 1] and ds.v.tolist() == [4, 2]
    np.testing.assert_allclose(ds.r, [3.0, 4.5])
    assert textfmt.detect_format(p) == "movielens"


def test_proto_roundtrip_python(tmp_path):
    ds = small_ds(n=1000)
    p = str(tmp_path / "train.pb")
    proto.write_block_frames(p, ds, users_per_block=7)
    back = proto.read_block_frames(p, nu=ds.nu, nv=ds.nv)
    assert_same_ratings(ds, back)
    assert textfmt.detect_format(p) == "proto"
    # read_any dispatches on sniffed format
    assert_same_ratings(ds, textfmt.read_any(p, nu=ds.nu, nv=ds.nv))


@pytest.fixture(scope="module")
def native():
    """The C++ codec, built from tpu_mf/native/mfdata.cpp when missing
    (the library is a build output, not a committed file)."""
    from tpu_mf import native as mod

    if not mod.available():
        if shutil.which("make") is None or shutil.which("g++") is None:
            pytest.skip("no C++ toolchain to build tpu_mf/native")
        subprocess.run(["make", "-C", os.path.dirname(mod.__file__)],
                       check=True, capture_output=True, timeout=300)
        mod._LIB_TRIED = False
    assert mod.available()
    return mod


def test_proto_native_matches_python(tmp_path, native):

    ds = small_ds(n=2000, nu=100, nv=60)
    ppy = str(tmp_path / "py.pb")
    pnat = str(tmp_path / "nat.pb")
    proto.write_block_frames(ppy, ds, users_per_block=13)

    # native parse of python-written file
    u, v, r = native.parse_frames_native(ppy)
    back = RatingsCOO(u, v, r, ds.nu, ds.nv)
    assert_same_ratings(ds, back)

    # native write, python parse
    order = np.argsort(ds.u, kind="stable")
    assert native.write_frames_native(
        pnat, ds.u[order], ds.v[order], ds.r[order], users_per_block=13
    )
    us, vs, rs = [], [], []
    for payload in proto.iter_frames(pnat):
        bu, bv, br = proto.parse_block(payload)
        us += bu; vs += bv; rs += br
    back2 = RatingsCOO(np.array(us), np.array(vs), np.array(rs), ds.nu, ds.nv)
    assert_same_ratings(ds, back2)


@pytest.mark.skipif(shutil.which("protoc") is None, reason="protoc unavailable")
def test_proto_wire_format_matches_official(tmp_path):
    """Cross-validate the hand-rolled codec against the protobuf runtime."""
    schema = tmp_path / "blocks.proto"
    schema.write_text(
        'syntax = "proto2";\npackage mf;\n'
        "message User { required int32 uid = 1;\n"
        "  message Record { required int32 vid = 1; required float rating = 2; }\n"
        "  repeated Record record = 2; }\n"
        "message Block { repeated User user = 1; }\n"
    )
    subprocess.run(
        ["protoc", f"--python_out={tmp_path}", "blocks.proto"],
        cwd=tmp_path,
        check=True,
    )
    sys.path.insert(0, str(tmp_path))
    try:
        import blocks_pb2  # generated

        blk = blocks_pb2.Block()
        u1 = blk.user.add()
        u1.uid = 42
        rec = u1.record.add(); rec.vid = 7; rec.rating = 3.5
        rec = u1.record.add(); rec.vid = 300; rec.rating = 1.25
        u2 = blk.user.add()
        u2.uid = 100000
        rec = u2.record.add(); rec.vid = 0; rec.rating = 5.0
        official = blk.SerializeToString()

        # our parser reads the official bytes
        us, vs, rs = proto.parse_block(official)
        assert us == [42, 42, 100000]
        assert vs == [7, 300, 0]
        np.testing.assert_allclose(rs, [3.5, 1.25, 5.0])

        # official parser reads our bytes
        ours = proto.serialize_block(
            np.array([42, 42, 100000]), np.array([7, 300, 0]),
            np.array([3.5, 1.25, 5.0], np.float32),
        )
        blk2 = blocks_pb2.Block()
        blk2.ParseFromString(ours)
        assert [u.uid for u in blk2.user] == [42, 100000]
        assert [r.vid for r in blk2.user[0].record] == [7, 300]
    finally:
        sys.path.remove(str(tmp_path))


def test_mf_checkpoint_roundtrip(tmp_path):
    params = init_mf(jax.random.PRNGKey(0), 20, 10, 8, gb=2.76)
    p = str(tmp_path / "model.bin")
    ckpt.save_mf_binary(p, params, lam=0.005)
    back, lam = ckpt.load_mf_binary(p, gb=2.76)
    assert lam == pytest.approx(0.005)
    for a, b in zip(params, back):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)


def test_dpmf_checkpoint_roundtrip(tmp_path):
    dim = 8
    params = init_mf(jax.random.PRNGKey(1), 20, 10, dim)
    lu = np.linspace(1, 2, dim).astype(np.float32)
    lv = np.linspace(3, 4, dim).astype(np.float32)
    p = str(tmp_path / "dpmf.bin")
    ckpt.save_dpmf_binary(p, params, 1.0, 100.0, 200.0, lu, lv)

    lr, lub, lvb, lu2, lv2 = ckpt.load_dpmf_hyper(p)
    assert (lr, lub, lvb) == (1.0, 100.0, 200.0)
    np.testing.assert_allclose(lu2, lu)
    np.testing.assert_allclose(lv2, lv)

    back, hypers = ckpt.load_dpmf_binary(p)
    for a, b in zip(params, back):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)
    assert hypers[0] == 1.0


def test_npz_roundtrip(tmp_path):
    params = init_mf(jax.random.PRNGKey(2), 5, 6, 4, gb=1.5)
    p = str(tmp_path / "state.npz")
    ckpt.save_npz(p, params, round=np.int32(7), eta=np.float32(0.01))
    back, extras = ckpt.load_npz(p)
    for a, b in zip(params, back):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))
    assert int(extras["round"]) == 7
    assert float(extras["eta"]) == pytest.approx(0.01)
