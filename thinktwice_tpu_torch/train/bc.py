"""Behavior cloning of the Roach expert policy from the rule-based autopilot
(counterpart of `thinktwice_tpu/train/bc.py`).

One iteration is a rollout and an update:

- the rollout drives W worlds with the autopilot, one recorded frame per
  macro step of 2 ticks (the expert's 10 Hz): with probability
  perturb_prob a world's ego is displaced and rotated *before* the
  observation; the frame holds the birdview (through K1, as uint8), the
  state vector and the teacher's clean action; the executed control carries
  steering noise, or with probability dagger_mix is the learned policy's;
  worlds that are done reset onto a training route;
- the update fits the Beta negative log-likelihood of the jittered labels
  (stopped-and-holding frames weighted down, restart frames up), a
  discounted-return value regression and a small concentration penalty,
  with Adam after a global-norm clip of 1.0.

`eval_fn` is the closed-loop probe on the held-out tail of the route bank:
the policy's mode actions alone, no teacher and no noise. Every random
number comes from a draws provider (`train/draws.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from thinktwice_tpu_torch.agents.autopilot import autopilot_control
from thinktwice_tpu_torch.agents.expert import state_vector
from thinktwice_tpu_torch.agents.roach import acc_to_control, beta_log_prob, beta_mode
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.maps.town import TownMap
from thinktwice_tpu_torch.sensors.birdview import birdview_from_state
from thinktwice_tpu_torch.sim.state import ScenarioState
from thinktwice_tpu_torch.sim.step import step_world
from thinktwice_tpu_torch.train.ppo import (
    WorldBank,
    compute_reward,
    flatten_traj,
    hazard_desired_speed,
    make_policy,
    minibatch_epochs,
)
from thinktwice_tpu_torch.train.train_step import Adam

GAMMA = 0.99
ACTION_JITTER = 0.03     # label smoothing on [-1, 1] actions
CONC_PENALTY = 1e-4      # keeps alpha + beta from running away on clean labels
VALUE_COEF = 0.25
MAX_GRAD_NORM = 1.0
TICKS_PER_FRAME = 2


def control_to_acc(control):
    """(steer, throttle, brake) -> (acc, steer) in [-1, 1], the inverse of
    roach.acc_to_control."""
    return torch.stack([control[..., 1] - control[..., 2], control[..., 0]], dim=-1)


@dataclasses.dataclass
class BCConfig:
    n_envs: int = 24
    n_steps: int = 256          # sim ticks per rollout (one frame every 2)
    steer_noise: float = 0.08   # exploration noise on the applied steering
    minibatch: int = 256
    n_epochs: int = 2
    lr: float = 3e-4
    n_vehicles: int = 24
    seed: int = 0
    dagger_mix: float = 0.0     # probability a world executes the learned policy
    perturb_prob: float = 0.0   # probability a world's ego is displaced a macro step
    perturb_lat: float = 1.5    # ... up to this many meters sideways
    perturb_yaw: float = 0.35   # ... and this many radians
    eval_envs: int = 8          # worlds of the held-out probe (the bank's tail routes)
    eval_steps: int = 768       # sim ticks of the probe


def make_bc(cfg: Config, bcfg: BCConfig, town: TownMap, routes,
            scenarios: ScenarioState | None = None):
    """routes (NR, R, 3): the route bank; the tail eval_envs routes are held
    out for the probe and resets draw from the others. scenarios: an
    optional ScenarioState with NR rows. The trainer runs on the town's
    device. -> (init_fn, iterate_fn).

    init_fn(draws) -> (policy, opt_state, env_states).
    iterate_fn(policy, opt_state, env_states, draws, dagger_mix=None,
               probe=None) -> (policy, opt_state, env_states, metrics);
        iterate_fn.rollout_fn, .update_fn and .eval_fn are its stages."""
    dev = town.device
    W = bcfg.n_envs
    routes = torch.as_tensor(routes, dtype=torch.float32, device=dev)
    NR = routes.shape[0]
    bank = WorldBank(cfg, town, routes, bcfg.n_vehicles, scenarios,
                     n_routes=max(NR - bcfg.eval_envs, 1))
    tx = Adam(bcfg.lr, MAX_GRAD_NORM)

    def init_fn(draws):
        gen = torch.Generator(device=dev).manual_seed(bcfg.seed)
        policy = make_policy(cfg, dev, gen)
        return policy, tx.init(dict(policy.named_parameters())), bank.reset_all(draws, W)

    def perturb(states, draws):
        """The ego displaced sideways and rotated in the drawn worlds."""
        do_p, lat_u, yaw_u = draws.perturb(W, bcfg.perturb_prob, dev)
        lat, dyaw = bcfg.perturb_lat * lat_u, bcfg.perturb_yaw * yaw_u
        ego = states.ego
        right = torch.stack([-torch.sin(ego.yaw), torch.cos(ego.yaw)], dim=-1)
        ego = dataclasses.replace(
            ego,
            pos=ego.pos + torch.where(do_p[:, None], lat[:, None] * right, 0.0),
            yaw=ego.yaw + torch.where(do_p, dyaw, 0.0),
        )
        return dataclasses.replace(states, ego=ego)

    def macro_step(policy, states, draws, mix: float):
        draws.macro()
        if bcfg.perturb_prob > 0.0:
            states = perturb(states, draws)
        bv = birdview_from_state(cfg.birdview, town, states)
        sv = state_vector(states)
        ctrl = autopilot_control(cfg, town, states)
        # noisy execution, the teacher's clean action as the label
        noise = bcfg.steer_noise * draws.steer_noise(W, dev)
        ctrl_exec = torch.cat([ctrl[:, :1] + noise[:, None], ctrl[:, 1:]], dim=-1)
        use_pol = draws.dagger(W, mix, dev)
        if mix > 0.0:
            out = policy(bv, sv)
            pol_ctrl = acc_to_control(beta_mode(out["alpha"], out["beta"]))
            ctrl_exec = torch.where(use_pol[:, None], pol_ctrl, ctrl_exec)
        rew_sum = 0.0
        for _ in range(TICKS_PER_FRAME):
            new, events = step_world(cfg, town, states, ctrl_exec, draws=draws.step(states))
            desired = hazard_desired_speed(cfg, town, states)
            rew, _ = compute_reward(states, new, events, desired)
            rew_sum = rew_sum + rew
            states = new
        done = states.criteria.done
        frame = {"bv_u8": (bv * 255.0).to(torch.uint8), "sv": sv,
                 "action": control_to_acc(ctrl), "reward": rew_sum, "done": done}
        return bank.reset_done(states, done, draws), frame

    @torch.no_grad()
    def rollout_fn(policy, env_states, draws, dagger_mix: float = 0.0):
        """-> (env_states, trajectory of (n_steps // 2, W, ...) fields)."""
        T = bcfg.n_steps // TICKS_PER_FRAME
        traj = None
        states = env_states
        for t in range(T):
            states, frame = macro_step(policy, states, draws, float(dagger_mix))
            if traj is None:
                traj = {k: torch.empty((T, *v.shape), dtype=v.dtype, device=v.device)
                        for k, v in frame.items()}
            for k, v in frame.items():
                traj[k][t] = v
        return states, traj

    def discounted_returns(traj):
        g2 = GAMMA * GAMMA   # one frame spans two ticks
        rets = torch.empty_like(traj["reward"])
        ret = torch.zeros_like(traj["reward"][0])
        for t in reversed(range(traj["reward"].shape[0])):
            ret = traj["reward"][t] + g2 * ret * (1.0 - traj["done"][t].to(torch.float32))
            rets[t] = ret
        return rets

    def loss_fn(policy, batch, jitter):
        bv = batch["bv_u8"].to(torch.float32) / 255.0
        out = policy(bv, batch["sv"])
        jit_a = torch.clamp(batch["action"] + ACTION_JITTER * jitter, -0.999, 0.999)
        # stopped-and-holding frames weighted down, restart frames up
        stopped = batch["sv"][:, 4] < 0.3
        hold_label = batch["action"][:, 0] < 0.1
        restart_label = batch["action"][:, 0] > 0.3
        w = torch.where(stopped & hold_label, 0.2, 1.0)
        w = torch.where(stopped & restart_label, 3.0, w)
        w = w / torch.mean(w)
        per = -beta_log_prob(jit_a, out["alpha"], out["beta"])
        # the JAX package's (B, 1) x (B,) product: a (B, B) mean, so the
        # weights enter only through their mean, which is 1
        nll = torch.mean(w[:, None] * per)
        v_err = torch.mean((out["value"][:, 0] - batch["ret"]) ** 2)
        conc = torch.mean(out["alpha"] + out["beta"])
        loss = nll + VALUE_COEF * v_err + CONC_PENALTY * conc
        mode = beta_mode(out["alpha"], out["beta"])
        mae = torch.mean(torch.abs(mode - batch["action"]))
        return loss, {"bc_nll": nll, "v_mse": v_err, "conc": conc, "action_mae": mae}

    def update_fn(policy, opt_state, flat, draws, probe=None):
        """-> (opt_state, the last minibatch's metrics)."""
        n = flat["action"].shape[0]
        mb = min(bcfg.minibatch, n)

        def loss_i(batch, i):
            return loss_fn(policy, batch, draws.label_jitter(i, batch["action"].shape, dev))

        return minibatch_epochs(dict(policy.named_parameters()), tx, opt_state, flat,
                                bcfg.n_epochs, mb, draws, loss_i, probe)

    @torch.no_grad()
    def eval_fn(policy, draws):
        """The probe: eval_envs worlds on the bank's tail routes, the policy's
        mode actions every 2 ticks for eval_steps ticks; done worlds freeze.
        -> the mean route completion, the collisions and red lights, the
        worlds done and the mean speed."""
        E = bcfg.eval_envs
        idxs = (NR - 1 - torch.arange(E, device=dev)) % NR
        states = bank.fresh(idxs, draws.probe_reset(E))
        speeds = []
        for _ in range(bcfg.eval_steps // TICKS_PER_FRAME):
            out = policy(birdview_from_state(cfg.birdview, town, states),
                         state_vector(states))
            ctrl = acc_to_control(beta_mode(out["alpha"], out["beta"]))
            speeds.append(states.ego.speed)
            for _ in range(TICKS_PER_FRAME):
                states, _ = step_world(cfg, town, states, ctrl, draws=draws.step(states))
        c = states.criteria
        return {
            "cl_completion": torch.mean(c.route_completion),
            "cl_collisions": torch.sum(c.n_collision_vehicle + c.n_collision_walker
                                       + c.n_collision_static).to(torch.float32),
            "cl_red": torch.sum(c.n_red_light).to(torch.float32),
            "cl_done": torch.sum(c.done).to(torch.float32),
            "cl_speed": torch.mean(torch.stack(speeds)),
        }

    def iterate_fn(policy, opt_state, env_states, draws, dagger_mix: float | None = None,
                   probe: Callable[[str, object], None] | None = None):
        mix = bcfg.dagger_mix if dagger_mix is None else dagger_mix
        env_states, traj = rollout_fn(policy, env_states, draws, mix)
        flat = flatten_traj(traj, ("bv_u8", "sv", "action"))
        flat["ret"] = discounted_returns(traj).reshape(-1)
        if probe is not None:
            probe("rollout", traj)
        opt_state, metrics = update_fn(policy, opt_state, flat, draws, probe)
        metrics["mean_reward"] = traj["reward"].mean()
        metrics["mean_speed"] = traj["sv"][..., 4].mean()
        metrics["dones"] = traj["done"].sum()
        return policy, opt_state, env_states, metrics

    iterate_fn.rollout_fn = rollout_fn
    iterate_fn.update_fn = update_fn
    iterate_fn.eval_fn = eval_fn
    iterate_fn.discounted_returns = discounted_returns
    return init_fn, iterate_fn
