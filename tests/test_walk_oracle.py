"""The XLA lockstep walks against the numpy oracle of the reference's
optimizers, candidate by candidate, on seeded pose-shaped scenes."""
import pytest

import openfdcm_tpu as of
from tests import synthetic
from tests.walk_parity import compare_walks

_OPTIMIZERS = {"default": of.DefaultOptimize(),
               "indulgent": of.IndulgentOptimize(),
               "batch": of.BatchOptimize(10)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", sorted(_OPTIMIZERS))
def test_walk_matches_oracle(mode, seed):
    obj = synthetic.make_object(seed, seed % 4, n_scenes=1, n_templates=3)
    scene = obj.scenes[0]
    fmap = of.build_featuremap(scene, of.Dt3Params(8, 5.0, 1.0,
                                                   of.Distance.L2))
    res = compare_walks(fmap, obj.templates, scene, of.DefaultSearch(4, 10),
                        _OPTIMIZERS[mode], n_sample=96, seed=seed)
    assert res["checked"] == 96 and res["valid"] > 0, res
    assert res["validity_mismatches"] == 0, res
    assert res["score_mismatches"] == 0, res
    assert res["translation_mismatches"] == 0, res
