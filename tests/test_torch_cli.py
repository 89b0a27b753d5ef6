"""The port's headless CLI (``polychase_tpu_torch.cli``): the cases of
``test_cli.py`` with ``--device cpu``, and the card as the default with no
fallback: with no ``--device`` and no card, ``generate_database`` exits
with 1 before it reads a frame or the DB.  ``visualize_flow`` runs on the
host and takes no device."""

import numpy as np
import pytest
import torch

from polychase_tpu_torch.cli import generate_database as gen_cli
from polychase_tpu_torch.cli import visualize_flow as viz_cli
from polychase_tpu_torch.io.database import Database

from test_opticalflow import make_clip

torch.set_num_threads(1)


@pytest.fixture
def frames_dir(tmp_path, rng):
    from PIL import Image

    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(make_clip(rng, n=6)):
        Image.fromarray(f).save(d / f"frame_{i:04d}.png")
    return d


def _generate(frames_dir, db_path, *extra):
    return gen_cli.main([
        "--images-dir", str(frames_dir),
        "--database-path", str(db_path),
        "--min-distance", "7",
        *extra,
    ])


def test_generate_database_cli(frames_dir, tmp_path, capsys):
    db_path = tmp_path / "flow.db"
    assert _generate(frames_dir, db_path, "--device", "cpu") == 0
    assert "Done" in capsys.readouterr().out

    db = Database(str(db_path))
    for fid in range(6):
        assert db.read_keypoints(fid).shape[0] > 10
    flow = db.read_image_pair_flow(2, 3)
    assert flow.src_kps_indices.size > 10
    db.close()


def test_visualize_flow_cli(frames_dir, tmp_path):
    from PIL import Image

    db_path = tmp_path / "flow.db"
    assert _generate(frames_dir, db_path, "--device", "cpu") == 0
    out_dir = tmp_path / "viz"
    rc = viz_cli.main([
        "--images-dir", str(frames_dir),
        "--database-path", str(db_path),
        "--output-dir", str(out_dir),
    ])
    assert rc == 0
    pngs = sorted(out_dir.glob("flow_*.png"))
    assert len(pngs) == 6
    overlay = np.asarray(Image.open(pngs[0]))
    orig = np.asarray(Image.open(sorted(frames_dir.glob("*.png"))[0]))
    assert overlay.shape[:2] == orig.shape[:2]
    assert not np.array_equal(overlay, orig)  # crosses/flow lines were drawn


def test_generate_database_cli_empty_dir(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    rc = gen_cli.main([
        "--images-dir", str(empty),
        "--database-path", str(tmp_path / "x.db"),
        "--device", "cpu",
    ])
    assert rc == 1


def test_cli_refuses_without_card(frames_dir, tmp_path, monkeypatch, capsys):
    from polychase_tpu_torch.engine import opticalflow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(opticalflow, "generate_optical_flow_database",
                        lambda *a, **k: ran.append(a))
    monkeypatch.setattr(Database, "open", lambda *a: ran.append(a))
    db_path = tmp_path / "flow.db"
    assert _generate(frames_dir, db_path) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert ran == []
    assert not db_path.exists()
