"""PPO trainer of the Roach expert on the batched world (counterpart of
`thinktwice_tpu/train/ppo.py`).

One iteration is a rollout and an update:

- the rollout drives W worlds for n_steps macro steps: the birdview through
  K1, a Beta sample of the policy held for `policy_every` ticks (rewards
  summed, infraction events OR-ed), the terminal flags, and an auto-reset
  of the worlds that are done. The trajectory stores the birdview as uint8;
  with an anchor policy its Beta parameters are stored beside it;
- the update runs GAE with the macro step's discount GAMMA ** policy_every,
  then n_epochs of minibatched clipped-surrogate steps (clip 0.2, value
  coefficient 0.5, entropy coefficient 0.01, Adam with eps 1e-5 after a
  global-norm clip of 0.5), with the KL(anchor || current) penalty when an
  anchor is given.

The reward is the JAX package's reconstruction of carla-roach's driving
reward: route progress and desired-speed tracking, less lateral and heading
deviation, off-road meters and infraction penalties.

Every random number comes from a draws provider (`train/draws.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from thinktwice_tpu_torch.agents.expert import hazard_brake, state_vector
from thinktwice_tpu_torch.agents.roach import (
    RoachPolicy,
    acc_to_control,
    beta_log_prob,
    init_roach_params,
)
from thinktwice_tpu_torch.config import Config
from thinktwice_tpu_torch.maps.town import TownMap, traffic_light_states
from thinktwice_tpu_torch.models.encoder_decoder import beta_kl
from thinktwice_tpu_torch.sensors.birdview import birdview_from_state
from thinktwice_tpu_torch.sim.reset import reset_world
from thinktwice_tpu_torch.sim.state import ScenarioState, WorldState, tree_map
from thinktwice_tpu_torch.sim.step import step_world
from thinktwice_tpu_torch.sim.traffic import _red_light_dist
from thinktwice_tpu_torch.train.train_step import Adam

GAMMA = 0.99
GAE_LAMBDA = 0.9
CLIP_RANGE = 0.2
VF_COEF = 0.5
ENT_COEF = 0.01
MAX_GRAD_NORM = 0.5
ADAM_EPS = 1e-5

DESIRED_SPEED = 6.0
R_SPEED = 0.3          # per-step weight on speed tracking
P_COLLISION = 10.0
P_RED_LIGHT = 5.0
P_OFFROAD = 2.0
P_TERMINAL_BLOCKED = 5.0
P_TIME = 0.1           # constant per-step cost
P_LATERAL = 0.2        # per-step, per-meter of lane-center deviation beyond 0.5 m
P_HEADING = 0.1        # per-step, per-radian of heading error vs the route
STUCK_S = 30.0         # standstill without a hazard that ends a training episode


def _beta_sample_and_logp(draws, alpha, beta):
    """A Beta(alpha, beta) action in [-1, 1] from the provider's two Gamma
    variates, and its log-density."""
    g1, g2 = draws.gamma(alpha, beta)
    x01 = torch.clamp(g1 / torch.clamp_min(g1 + g2, 1e-9), 1e-5, 1 - 1e-5)
    act = x01 * 2.0 - 1.0
    return act, beta_log_prob(act, alpha, beta)


def _beta_entropy(alpha, beta):
    """Differential entropy of Beta(alpha, beta), summed over the action dims."""
    lg, dg = torch.lgamma, torch.digamma
    lbeta = lg(alpha) + lg(beta) - lg(alpha + beta)
    ent = (lbeta - (alpha - 1) * dg(alpha) - (beta - 1) * dg(beta)
           + (alpha + beta - 2) * dg(alpha + beta))
    return torch.sum(ent, dim=-1)


def _beta_kl(a_p, b_p, a_q, b_q):
    """KL(Beta(a_p, b_p) || Beta(a_q, b_q)), summed over the action dims."""
    return torch.sum(beta_kl(a_p, b_p, a_q, b_q), dim=-1)


def hazard_desired_speed(cfg: Config, town: TownMap, state: WorldState):
    """(B,) target speed of the reward: 0 while a red or yellow stop line lies
    within 16 m ahead on the ego's approach or the motion forecast overlaps
    an actor, else DESIRED_SPEED."""
    ego = state.ego
    tl_states = traffic_light_states(town, state.time_s)
    d_red = _red_light_dist(town, tl_states, ego.pos[:, None], ego.yaw[:, None])[:, 0]
    stop = (d_red < 16.0) | hazard_brake(cfg, state)
    return torch.where(stop, 0.0, DESIRED_SPEED)


def compute_reward(prev: WorldState, new: WorldState, events,
                   desired_speed=DESIRED_SPEED, red_light_scale: float = 1.0):
    """-> (reward (B,), its components by name, each (B,)): progress and
    speed tracking (half weight while the target speed is 0), less lane
    position, heading and off-road deviation and the infraction penalties."""
    dev = new.tick.device
    B = new.n_worlds
    desired = torch.as_tensor(desired_speed, dtype=torch.float32, device=dev)
    progress = (new.criteria.route_completion - prev.criteria.route_completion) * new.route_len_m
    speed_err = torch.abs(new.ego.speed - desired)

    b = torch.arange(B, device=dev)
    idx = new.criteria.route_idx
    route_pt = new.route[b, idx, :2]
    route_yaw = new.route[b, idx, 2]
    lat = torch.linalg.norm(route_pt - new.ego.pos, dim=-1)
    d = route_yaw - new.ego.yaw
    dyaw = torch.abs(torch.atan2(torch.sin(d), torch.cos(d)))
    offlane_delta = new.criteria.dist_offlane - prev.criteria.dist_offlane

    def f(x):
        return x.to(torch.float32)

    speed_w = torch.where(desired > 0.0, R_SPEED, 0.5 * R_SPEED)
    comps = {
        "r_progress": 1.0 * progress,
        "r_speed": speed_w * (1.0 - speed_err / DESIRED_SPEED),
        "p_lateral": -P_LATERAL * torch.clamp(lat - 0.5, 0.0, 4.0),
        "p_heading": -P_HEADING * torch.clamp(dyaw, 0.0, 1.5),
        "p_offroad": -P_OFFROAD * offlane_delta,
        "p_collision": -P_COLLISION * (f(events.collision_vehicle) + f(events.collision_walker)
                                       + f(events.collision_static)),
        "p_red_light": -P_RED_LIGHT * red_light_scale * f(events.red_light),
        "p_blocked": -P_TERMINAL_BLOCKED * f(new.criteria.blocked & ~prev.criteria.blocked),
        "p_timeout": -P_TERMINAL_BLOCKED * f(new.criteria.timeout & ~prev.criteria.timeout),
        "p_time": torch.full((B,), -P_TIME, device=dev),
    }
    comps = {k: torch.broadcast_to(v, (B,)) for k, v in comps.items()}
    return sum(comps.values()), comps


@dataclasses.dataclass
class PPOConfig:
    n_envs: int = 16
    n_steps: int = 128          # rollout length per env (macro steps)
    n_epochs: int = 4
    minibatch: int = 256
    lr: float = 1e-4
    seed: int = 0
    n_vehicles: int = 0         # background traffic per world
    policy_every: int = 1       # ticks the sampled action is held
    anchor_coef: float = 0.0    # KL(anchor || current) coefficient
    red_light_scale: float = 1.0   # multiplier on P_RED_LIGHT


def make_policy(cfg: Config, device, generator: torch.Generator | None = None) -> RoachPolicy:
    """A RoachPolicy on device, its parameters drawn from the JAX package's
    initial distribution when a generator is given."""
    policy = RoachPolicy.from_config(cfg).to(device)
    if generator is not None:
        init_roach_params(policy, generator)
    return policy


class WorldBank:
    """The route bank (NR, R, 3) and an optional scenario bank (NR rows):
    resets the worlds that are done onto a drawn route."""

    def __init__(self, cfg: Config, town: TownMap, routes, n_vehicles: int,
                 scenarios: ScenarioState | None = None, n_routes: int | None = None):
        self.cfg, self.town, self.n_vehicles = cfg, town, n_vehicles
        self.routes = torch.as_tensor(routes, dtype=torch.float32, device=town.device)
        self.scenarios = (None if scenarios is None
                          else tree_map(lambda x: x.to(town.device), scenarios))
        self.n_routes = self.routes.shape[0] if n_routes is None else n_routes

    def fresh(self, idx, spawn) -> WorldState:
        scen = None if self.scenarios is None else tree_map(lambda x: x[idx], self.scenarios)
        return reset_world(self.cfg, self.town, self.routes[idx], n_vehicles=self.n_vehicles,
                           spawn_uniform=spawn, scenario=scen)

    def reset_all(self, draws, n_worlds: int) -> WorldState:
        draws.init()
        done = torch.ones((n_worlds,), dtype=torch.bool, device=self.town.device)
        idx, spawn = draws.reset(done, self.n_routes)
        return self.fresh(idx, spawn)

    def reset_done(self, states: WorldState, done, draws) -> WorldState:
        """The worlds where done is set replaced by fresh ones (the draws are
        taken for every world, as the JAX package's reset of every env)."""
        idx, spawn = draws.reset(done, self.n_routes)
        rows = torch.nonzero(done)[:, 0]
        if rows.numel() == 0:
            return states
        fresh = self.fresh(idx[rows], spawn[rows])
        return tree_map(lambda s, f: s.index_copy(0, rows, f), states, fresh)


def flatten_traj(traj: dict, keys) -> dict:
    """(T, W, ...) trajectory fields -> (T * W, ...)."""
    return {k: traj[k].reshape(-1, *traj[k].shape[2:]) for k in keys}


def minibatch_epochs(params: dict, tx, opt_state, flat: dict, n_epochs: int,
                     minibatch: int, draws, loss_fn, probe=None):
    """n_epochs passes over flat in minibatches of a drawn permutation, one
    optimizer step each. loss_fn(batch, i) -> (loss, metrics). -> (opt_state,
    the last minibatch's metrics, by sorted name as the JAX package's)."""
    n = next(iter(flat.values())).shape[0]
    nmb = max(n // minibatch, 1)
    dev = next(iter(flat.values())).device
    aux = None
    for _ in range(n_epochs):
        draws.epoch()
        perm = draws.permutation(n, dev)
        for i in range(nmb):
            idx = perm[i * minibatch:(i + 1) * minibatch]
            batch = {k: v[idx] for k, v in flat.items()}
            loss, aux = loss_fn(batch, i)
            got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), got)}
            if probe is not None:
                probe("minibatch", (batch, grads))
            opt_state, _ = tx.step(params, grads, opt_state)
    return opt_state, {k: aux[k].detach() for k in sorted(aux)}


def make_ppo(cfg: Config, ppo_cfg: PPOConfig, town: TownMap, routes,
             scenarios: ScenarioState | None = None,
             anchor: RoachPolicy | None = None):
    """routes (NR, R, 3): every reset draws a route from the bank.
    scenarios: an optional ScenarioState with NR rows (one per route).
    anchor: an optional frozen policy for the anchor_coef KL penalty. The
    trainer runs on the town's device. -> (init_fn, iterate_fn).

    init_fn(draws) -> (policy, opt_state, env_states): a policy drawn from
    the JAX package's initial distribution with seed ppo_cfg.seed, Adam's
    zero state and W reset worlds.
    iterate_fn(policy, opt_state, env_states, draws, probe=None) ->
        (policy, opt_state, env_states, metrics): the policy's parameters
        are updated in place; probe("minibatch", (batch, gradients)), when
        given, sees every minibatch. iterate_fn.rollout_fn, .gae and
        .update_fn are its stages."""
    dev = town.device
    W = ppo_cfg.n_envs
    bank = WorldBank(cfg, town, routes, ppo_cfg.n_vehicles, scenarios)
    tx = Adam(ppo_cfg.lr, MAX_GRAD_NORM, eps=ADAM_EPS)
    use_anchor = anchor is not None
    g_eff = GAMMA ** ppo_cfg.policy_every   # one macro step spans policy_every ticks

    def init_fn(draws):
        gen = torch.Generator(device=dev).manual_seed(ppo_cfg.seed)
        policy = make_policy(cfg, dev, gen)
        return policy, tx.init(dict(policy.named_parameters())), bank.reset_all(draws, W)

    def obs_of(states):
        return birdview_from_state(cfg.birdview, town, states), state_vector(states)

    def macro_step(policy, states, draws):
        """One macro step of every world -> (states after the auto-reset, the
        step's trajectory record)."""
        draws.macro()
        bv, sv = obs_of(states)
        out = policy(bv, sv)
        act, logp = _beta_sample_and_logp(draws, out["alpha"], out["beta"])
        ctrl = acc_to_control(act)
        rew, rcomps, infraction, desired = 0.0, None, torch.zeros_like(states.criteria.done), None
        new = states
        for _ in range(ppo_cfg.policy_every):
            cur = new
            new, events = step_world(cfg, town, cur, ctrl, draws=draws.step(cur))
            desired = hazard_desired_speed(cfg, town, cur)
            r_k, rc_k = compute_reward(cur, new, events, desired,
                                       red_light_scale=ppo_cfg.red_light_scale)
            rew = rew + r_k
            rcomps = rc_k if rcomps is None else {k: rcomps[k] + rc_k[k] for k in rcomps}
            infraction = infraction | (events.collision_vehicle | events.collision_walker
                                       | events.collision_static | events.red_light)
        rcomps["frac_hazard_stop"] = (desired == 0.0).to(torch.float32)
        stuck = ((new.criteria.blocked_s > STUCK_S) & (desired > 0.0)).to(torch.float32)
        rew = rew - P_TERMINAL_BLOCKED * stuck
        rcomps["p_blocked"] = rcomps["p_blocked"] - P_TERMINAL_BLOCKED * stuck
        done = new.criteria.done | infraction | (stuck > 0)
        rec = {"bv_u8": (bv * 255.0).to(torch.uint8), "sv": sv, "action": act, "logp": logp,
               "value": out["value"][:, 0], "reward": rew, "done": done, "rcomps": rcomps}
        if use_anchor:
            aout = anchor(bv, sv)
            rec["anchor_alpha"], rec["anchor_beta"] = aout["alpha"], aout["beta"]
        return bank.reset_done(new, done, draws), rec

    @torch.no_grad()
    def rollout_fn(policy, env_states, draws):
        """-> (env_states, trajectory of (T, W, ...) fields, the bootstrap
        value (W,) of the final states)."""
        traj = None
        states = env_states
        for t in range(ppo_cfg.n_steps):
            states, rec = macro_step(policy, states, draws)
            if traj is None:       # the trajectory's buffers, the birdviews as uint8
                traj = {k: ({c: torch.empty((ppo_cfg.n_steps, *x.shape), dtype=x.dtype,
                                            device=x.device) for c, x in v.items()}
                            if isinstance(v, dict) else
                            torch.empty((ppo_cfg.n_steps, *v.shape), dtype=v.dtype,
                                        device=v.device))
                        for k, v in rec.items()}
            for k, v in rec.items():
                if isinstance(v, dict):
                    for c, x in v.items():
                        traj[k][c][t] = x
                else:
                    traj[k][t] = v
        bv, sv = obs_of(states)
        last_value = policy(bv, sv)["value"][:, 0]
        return states, traj, last_value

    def gae(traj, last_value):
        """-> (advantages, returns), each (T, W)."""
        T = traj["reward"].shape[0]
        advs = torch.empty_like(traj["reward"])
        adv_next, v_next = torch.zeros_like(last_value), last_value
        for t in reversed(range(T)):
            nonterm = 1.0 - traj["done"][t].to(torch.float32)
            delta = traj["reward"][t] + g_eff * v_next * nonterm - traj["value"][t]
            adv_next = delta + g_eff * GAE_LAMBDA * nonterm * adv_next
            advs[t] = adv_next
            v_next = traj["value"][t]
        return advs, advs + traj["value"]

    def loss_fn(policy, batch):
        bv = batch["bv_u8"].to(torch.float32) / 255.0
        out = policy(bv, batch["sv"])
        logp = beta_log_prob(batch["action"], out["alpha"], out["beta"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg1 = adv * ratio
        pg2 = adv * torch.clamp(ratio, 1 - CLIP_RANGE, 1 + CLIP_RANGE)
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        v_loss = torch.mean((out["value"][:, 0] - batch["ret"]) ** 2)
        ent = torch.mean(_beta_entropy(out["alpha"], out["beta"]))
        total = pg_loss + VF_COEF * v_loss - ENT_COEF * ent
        kl = torch.mean(batch["logp"] - logp)
        aux = {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent, "kl": kl}
        if use_anchor and ppo_cfg.anchor_coef > 0.0:
            akl = torch.mean(_beta_kl(batch["anchor_alpha"], batch["anchor_beta"],
                                      out["alpha"], out["beta"]))
            total = total + ppo_cfg.anchor_coef * akl
            aux["anchor_kl"] = akl
        return total, aux

    def update_fn(policy, opt_state, flat, draws, probe=None):
        """-> (opt_state, the last minibatch's metrics)."""
        return minibatch_epochs(dict(policy.named_parameters()), tx, opt_state, flat,
                                ppo_cfg.n_epochs, ppo_cfg.minibatch, draws,
                                lambda batch, i: loss_fn(policy, batch), probe)

    def iterate_fn(policy, opt_state, env_states, draws,
                   probe: Callable[[str, object], None] | None = None):
        env_states, traj, last_value = rollout_fn(policy, env_states, draws)
        advs, rets = gae(traj, last_value)
        keys = ["bv_u8", "sv", "action", "logp"] + (
            ["anchor_alpha", "anchor_beta"] if use_anchor else [])
        flat = flatten_traj(traj, keys)
        flat["adv"], flat["ret"] = advs.reshape(-1), rets.reshape(-1)
        if probe is not None:
            probe("rollout", traj)
        opt_state, metrics = update_fn(policy, opt_state, flat, draws, probe)
        metrics["mean_reward"] = traj["reward"].mean()
        metrics["mean_speed"] = traj["sv"][..., 4].mean()
        metrics["dones"] = traj["done"].sum()
        for k in sorted(traj["rcomps"]):
            metrics[k] = traj["rcomps"][k].mean()
        return policy, opt_state, env_states, metrics

    iterate_fn.rollout_fn = rollout_fn
    iterate_fn.gae = gae
    iterate_fn.update_fn = update_fn
    return init_fn, iterate_fn
