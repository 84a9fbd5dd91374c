"""PyTorch port parity: the student's decoder of thinktwice_tpu_torch against
its flax module in thinktwice_tpu on the CPU, in float32, and the port's
converter on the student_rl6 archive.

The cascade of 2 refine layers (the shared BEV pyramid, SpatialGRU, the
prediction module, the look module with its deformable attention, the
offset heads) runs in both packages on the same inputs with the same
(perturbed) parameters; outputs agree to 1e-4 of their scale, as the other
modules in tests/test_torch_model.py. The flax decoder is given the lidar
BEV, so it builds and runs its lidar look branch and then zeroes it; the
port holds that branch's parameters and gives the zeros directly.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import SMALL, assert_close, nchw, paired, rand
from thinktwice_tpu.config import CameraConfig as JaxCameraConfig
from thinktwice_tpu.config import ModelConfig as JaxModelConfig
from thinktwice_tpu.models import decoder as jdec
from thinktwice_tpu.models import rig as jrig
from thinktwice_tpu_torch.config import Config, ModelConfig
from thinktwice_tpu_torch.models import decoder as dec
from thinktwice_tpu_torch.weights import (
    load_flax_msgpack,
    load_student_model,
    student_arch,
    student_state_dict_from_flax,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDENT_RL6 = os.path.join(REPO, "runs", "student_rl6", "params.msgpack")


class _JaxDecoder(fnn.Module):
    """The flax decoder with the BEV pyramid it shares, as the model holds
    them."""

    cfg: JaxModelConfig

    @fnn.compact
    def __call__(self, flat, bev32, meas, e2i, maps, flat_vals, lidar_hr):
        pyramid = jdec.BEVPyramid(name="bev_pyramid")
        shapes = tuple((m.shape[2], m.shape[3]) for m in maps)
        return jdec.ThinkTwiceDecoder(self.cfg, name="decoder")(
            flat, bev32, meas, e2i, {"maps": maps, "flat": flat_vals}, shapes, pyramid,
            lidar_hr)


class _Decoder(torch.nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.bev_pyramid = dec.BEVPyramid()
        self.decoder = dec.ThinkTwiceDecoder(cfg)

    def forward(self, flat, bev32, meas, e2i, maps, flat_vals):
        shapes = tuple(tuple(m.shape[2:4]) for m in maps)
        return self.decoder(flat, bev32, meas, e2i, {"maps": maps, "flat": flat_vals},
                            shapes, self.bev_pyramid)


def test_decoder_matches_flax():
    """The cascade (BEV pyramid, SpatialGRU, prediction, look with
    deformable attention, offsets) of 2 refine layers at float32."""
    jm, m = JaxModelConfig(**SMALL), ModelConfig(**SMALL)
    B, N = 2, 2
    e2i = jrig.ego_to_img(JaxCameraConfig(height=32, width=64, n_cams=2,
                                          cam_yaws=(0.0, 180.0)))
    shapes = ((8, 16), (4, 8), (2, 4), (1, 2))
    maps = [rand(B, N, h, w, 256, seed=i) for i, (h, w) in enumerate(shapes)]
    flat_vals = np.concatenate([mp.reshape(B, N, -1, 256) for mp in maps], 2).swapaxes(0, 1)
    args = [rand(B, 256, seed=7), rand(B, 21, 21, 32, seed=8), rand(B, 128, seed=9), e2i,
            maps, np.ascontiguousarray(flat_vals), rand(B, 84, 84, 512, seed=10)]
    fmod = _JaxDecoder(jm)
    t = _Decoder(m)
    jargs = jax.tree.map(jnp.asarray, args)
    _, ref = paired(fmod, t, *jargs)
    targs = [torch.as_tensor(a) for a in args[:4]]
    targs[1] = nchw(args[1])
    out = t(*targs, [torch.as_tensor(mp) for mp in maps], torch.as_tensor(args[5]))
    for key in ("pred_wp", "mu_branches", "sigma_branches", "pred_speed", "future_mu",
                "pred_value_traj", "pred_value_ctrl", "refine_flat_feature"):
        assert_close(out[key].detach(), ref[key])
    assert_close(np.moveaxis(out["refine_BEV_feature"].detach().numpy(), 2, -1),
                 ref["refine_BEV_feature"])


def test_student_rl6_archive_converts():
    """Every leaf of runs/student_rl6 maps onto the port's ThinkTwiceModel
    (ResNet-50, two sweeps, 4 cameras): 84,768,277 parameters."""
    tree = load_flax_msgpack(STUDENT_RL6)
    assert student_arch(tree) == (50, 2)
    n_leaves = len(jax.tree.leaves(tree))
    model = load_student_model(STUDENT_RL6, Config(), device="cpu")
    assert len(model.state_dict()) == n_leaves
    assert sum(p.numel() for p in model.parameters()) == 84_768_277
    leaf = tree["params"]["img_encoder"]["lss"]["backbone"]["CheckpointBottleneck_10"]
    np.testing.assert_array_equal(
        model.img_encoder.lss.backbone.blocks[10].ConvGN_1.Conv_0.weight.detach().numpy(),
        np.transpose(leaf["ConvGN_1"]["Conv_0"]["kernel"], (3, 2, 0, 1)))


def test_converter_rejects_a_mismatched_tree():
    model = dec.BEVPyramid()
    variables = jdec.BEVPyramid().init(jax.random.key(0), jnp.zeros((1, 21, 21, 32)))
    tree = jax.tree.map(np.asarray, variables)
    student_state_dict_from_flax(tree, model)
    extra = {"params": {**tree["params"], "Dense_9": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="no parameter"):
        student_state_dict_from_flax(extra, model)
    fewer = {"params": {k: v for k, v in tree["params"].items() if k != "Dense_1"}}
    with pytest.raises(KeyError, match="no flax leaf"):
        student_state_dict_from_flax(fewer, model)
