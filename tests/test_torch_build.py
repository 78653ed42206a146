"""The port's kernel build names (``kernels/_build._target``).

A library's name carries a hash of its source, of every ``csrc/*.cuh`` the
source includes and of the flags, so editing a shared header rebuilds each
library that includes it and no other. Only hashes are computed here: no
``nvcc`` is needed.
"""

import os
import shutil

from fastmatch_tpu_torch.kernels import _build


def test_header_edit_renames_its_includers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {name: _build._target(name) for name in _build.SOURCES}
    assert len(set(before.values())) == len(before)
    for name in ("batch_match", "distance_topk"):
        assert "match_tile.cuh" in [os.path.basename(p) for p in
                                    _build._sources(str(csrc / f"{name}.cu"), [])]
    with open(csrc / "match_tile.cuh", "a") as fh:
        fh.write("\n// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert after["batch_match"] != before["batch_match"]
    assert after["distance_topk"] != before["distance_topk"]
    for name in ("gather_rows", "patch_gather", "segment_sum"):
        assert after[name] == before[name]


def test_source_edit_renames_only_itself(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    before = {name: _build._target(name) for name in _build.SOURCES}
    with open(csrc / "distance_topk.cu", "a") as fh:
        fh.write("\n// edited\n")
    after = {name: _build._target(name) for name in _build.SOURCES}
    assert [n for n in _build.SOURCES if after[n] != before[n]] == ["distance_topk"]
