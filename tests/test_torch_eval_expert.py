"""PyTorch port parity: the route evaluator with the Roach expert
(roach_rl6) of thinktwice_tpu_torch against thinktwice_tpu's on the CPU.

Two grid-town routes in one batch of 2 worlds, 8 vehicles, the JAX suite's
small_cfg capacities, the policy every 2 ticks, 16-tick segments, 48 ticks;
both packages draw from the reference's key chain (JaxChainDraws). On the
CPU the port's expert renders through K1's plain version, the JAX one
through its XLA birdview, whose edge pixels may differ, so the controls
differ within the policy's float tolerance: the records must be equal in
status and infraction counts and within 1e-2 in the scores, route_length
and duration_game.
"""

import json

import numpy as np
import torch
from flax import serialization

from test_torch_evaluator import JaxChainDraws, assert_documents_match, straight_route
from test_torch_sim import configs, towns
from test_torch_slice import RL6
from thinktwice_tpu.agents.expert import make_expert_policy as jax_make_expert_policy
from thinktwice_tpu.harness import evaluator as j_eval
from thinktwice_tpu_torch.agents.expert import make_expert_policy
from thinktwice_tpu_torch.harness import evaluator as t_eval
from thinktwice_tpu_torch.weights import load_roach_policy

torch.set_num_threads(1)

ROUTES = [straight_route(74.0, 98.25, 60.0), straight_route(-20.0, -1.75, 80.0)]
IDS = ["east through the junction", "past the stop sign"]


def test_evaluate_routes_expert_matches_jax(tmp_path):
    jcfg, tcfg = configs()
    jtown, ttown = towns()
    with open(RL6, "rb") as f:
        params = serialization.msgpack_restore(f.read())
    kw = dict(n_vehicles=8, max_steps=48, worlds_per_batch=2, seed=11,
              segment_steps=16, policy_every=2)
    paths = {p: str(tmp_path / f"{p}.json") for p in "tj"}
    j_eval.evaluate_routes(jcfg, jtown, ROUTES, IDS, jax_make_expert_policy(jcfg, params),
                           out_path=paths["j"], **kw)
    policy = load_roach_policy(RL6, tcfg, device="cpu")
    log = []
    t_eval.evaluate_routes(tcfg, ttown, ROUTES, IDS, make_expert_policy(tcfg, policy),
                           out_path=paths["t"], draws=JaxChainDraws(11), batch_log=log, **kw)
    t_doc, j_doc = (json.load(open(paths[p])) for p in "tj")
    assert_documents_match(t_doc, j_doc)
    assert log == [dict(routes=2, worlds=2, ticks=48, seconds=log[0]["seconds"])]
    scores = [r["scores"]["score_route"] for r in t_doc["_checkpoint"]["records"]]
    assert np.all(np.asarray(scores) > 0.0), scores
