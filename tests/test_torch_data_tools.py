"""The port's data tools vs the JAX package's: batch face alignment
(cli/align_batch.py) and the packed image dataset (train/dataset.py).

Host code on both sides (cv2, PIL, scipy, numpy), so everything is exact:
the aligned crops byte-equal with the same exit code and messages, the
shards and meta.json byte-equal, and each batch equal to JAX's NHWC batch
after the transpose to NCHW.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_train_stage1 import lean_worker  # noqa: F401
from vtoonify_tpu.cli import align_batch as JA
from vtoonify_tpu.train import dataset as JD
from vtoonify_tpu_torch.cli import align_batch as A
from vtoonify_tpu_torch.train import dataset as D


def _align_tree(root):
    """Two decodable portraits (png, nested jpg), a text file, an
    unreadable .jpg, and one (68, 2) landmark set for all of them."""
    import cv2

    rng = np.random.RandomState(61)
    os.makedirs(os.path.join(root, "sub"))
    base = rng.randint(0, 255, (12, 12, 3), np.uint8)
    img = cv2.resize(base, (700, 700), interpolation=cv2.INTER_CUBIC)
    cv2.imwrite(os.path.join(root, "a.png"), img)
    cv2.imwrite(os.path.join(root, "sub", "b.jpg"), img[::-1].copy())
    with open(os.path.join(root, "notes.txt"), "w") as f:
        f.write("skip me")
    with open(os.path.join(root, "sub", "broken.jpg"), "wb") as f:
        f.write(b"not a jpeg")
    lm = np.zeros((68, 2), np.float32)
    lm[0:17] = np.stack([np.linspace(200, 520, 17),
                         340 + 130 * np.sin(np.linspace(0, np.pi, 17))], axis=1)
    lm[36:42] = [300, 320]
    lm[42:48] = [420, 320]
    lm[48:68] = [360, 460]
    lm[48], lm[54] = [330, 460], [390, 462]
    lm[27:36] = [360, 380]
    path = os.path.join(os.path.dirname(root), "lm.npy")
    np.save(path, lm)
    return path


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("threads", [1, 2])
def test_align_batch_matches_jax(tmp_path, capsys, threads):
    """The crops byte-equal to JAX's command's, the same exit code (1: the
    unreadable image) and report; a second run skips what exists. Two
    threads run the spawned pool."""
    root = str(tmp_path / "faces")
    lm = _align_tree(root)
    args = ["--root_path", root, "--landmarks", lm, "--num_threads", str(threads)]
    rc_jax = JA.main(args)
    want_out = capsys.readouterr().out
    os.rename(root + "_crops", str(tmp_path / "jax_crops"))
    rc = A.main(args)
    got_out = capsys.readouterr().out
    assert rc == rc_jax == 1
    got, want = _files(root + "_crops"), _files(str(tmp_path / "jax_crops"))
    assert sorted(got) == sorted(want) == ["a.jpg", os.path.join("sub", "b.jpg")]
    assert got == want
    strip = [ln for ln in got_out.splitlines() if not ln.startswith("aligned")]
    assert strip == [ln for ln in want_out.splitlines() if not ln.startswith("aligned")]
    assert "Running on 3 paths" in got_out and "unreadable" in got_out
    assert A.list_pending(root) == JA.list_pending(root) == [
        (os.path.join(root, "sub", "broken.jpg"),
         os.path.join(root + "_crops", "sub", "broken.jpg"))]
    os.remove(os.path.join(root, "sub", "broken.jpg"))
    assert A.main(args) == 0 and "Running on 0 paths" in capsys.readouterr().out
    shutil.rmtree(root + "_crops")


def _images(root, rng, n=5):
    import cv2

    paths = []
    for i in range(n):
        sub = os.path.join(root, "nested" if i % 2 else "")
        os.makedirs(sub, exist_ok=True)
        p = os.path.join(sub, f"{i}.png")
        cv2.imwrite(p, rng.randint(0, 255, (40, 30, 3), dtype=np.uint8))
        paths.append(p)
    return sorted(paths)


def test_prepare_data_matches_jax(tmp_path):
    """prepare_data and the command: the same shard files, byte for byte,
    and either package's dataset reads the other's shards."""
    paths = _images(str(tmp_path / "imgs"), np.random.RandomState(1))
    D.prepare_data(paths, str(tmp_path / "port"), sizes=(16, 32), shard_size=2)
    JD.prepare_data(paths, str(tmp_path / "jax"), sizes=(16, 32), shard_size=2)
    got, want = _files(str(tmp_path / "port")), _files(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) and "32-00002.npy" in got and "meta.json" in got
    assert got == want
    D.main([str(tmp_path / "imgs"), "--out", str(tmp_path / "cli_port"), "--size", "16",
            "--shard_size", "2"])
    JD.main([str(tmp_path / "imgs"), "--out", str(tmp_path / "cli_jax"), "--size", "16",
             "--shard_size", "2"])
    assert _files(str(tmp_path / "cli_port")) == _files(str(tmp_path / "cli_jax"))
    ds = D.MultiResolutionDataset(str(tmp_path / "jax"), resolution=32)
    jds = JD.MultiResolutionDataset(str(tmp_path / "port"), resolution=32)
    assert len(ds) == len(jds) == 5
    for i in range(5):
        np.testing.assert_array_equal(ds[i], jds[i])
    with pytest.raises(SystemExit, match="no images"):
        D.main([str(tmp_path / "empty_dir_missing"), "--out", str(tmp_path / "x")])


@pytest.mark.parametrize("count", [1, 2, 3])
def test_dataset_batches_match_jax(tmp_path, count):
    """Every process's batches over two epochs equal JAX's (the same
    shuffle, shard and dropped partial batch), as float32 NCHW."""
    paths = _images(str(tmp_path / "imgs"), np.random.RandomState(2), n=7)
    D.prepare_data(paths, str(tmp_path / "packed"), sizes=(16,), shard_size=3)
    ds = D.MultiResolutionDataset(str(tmp_path / "packed"), resolution=16)
    jds = JD.MultiResolutionDataset(str(tmp_path / "packed"), resolution=16)
    for shuffle, drop_last in ((True, True), (False, False)):
        for rank in range(count):
            kw = dict(shuffle=shuffle, seed=4, drop_last=drop_last, process_index=rank,
                      process_count=count, epochs=2)
            got, want = list(ds.batches(2, **kw)), list(jds.batches(2, **kw))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.moveaxis(w, -1, 1))
