"""The seeded pose data set (``tests/synthetic.py``): shapes, determinism
and the planted ground truth."""
import numpy as np
import pytest

from openfdcm_tpu.matching import featuremap as fm
from tests import synthetic


@pytest.mark.parametrize("obj", range(4))
def test_object_shapes(obj):
    o = synthetic.make_object(0, obj)
    assert len(o.templates) == synthetic.OBJECT_TEMPLATES[obj]
    assert max(t.shape[0] for t in o.templates) == \
        synthetic.OBJECT_MAX_LINES[obj]
    assert all(t.dtype == np.float32 and t.shape[1] == 4
               for t in o.templates)
    assert len(o.scenes) == synthetic.SCENES_PER_OBJECT
    for s in o.scenes:
        assert 250 <= s.shape[0] <= 400 and s.dtype == np.float32
        _, (w, h) = fm.scene_centered_translation(s, 1.0)
        assert -(-max(w, h) // 128) * 128 == 640


def test_dataset_totals():
    objs = synthetic.make_pose_dataset(3, n_scenes=1)
    assert sum(len(o.templates) for o in objs) == 421
    assert 29 <= min(synthetic.OBJECT_MAX_LINES)
    assert max(synthetic.OBJECT_MAX_LINES) <= 33


def test_deterministic_per_seed():
    a, b = synthetic.make_object(5, 2), synthetic.make_object(5, 2)
    c = synthetic.make_object(6, 2)
    for x, y in zip(a.templates + a.scenes, b.templates + b.scenes):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.planted, b.planted)
    assert not np.array_equal(a.scenes[0], c.scenes[0])


def test_planted_template_is_in_its_scene():
    o = synthetic.make_object(1, 0, n_scenes=3)
    for s, t, m in zip(o.scenes, o.planted, o.transforms):
        tmpl = o.templates[int(t)].astype(np.float64)
        moved = np.concatenate([tmpl[:, 0:2] @ m[:, :2].T + m[:, 2],
                                tmpl[:, 2:4] @ m[:, :2].T + m[:, 2]], axis=1)
        d = np.abs(s[None, :, :] - moved[:, None, :]).max(axis=-1)
        assert (d.min(axis=1) < 1e-3).all()
