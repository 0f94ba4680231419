"""Plain references for the bench's correctness checks, written from the
definitions and sharing no code with the modules they check.

  * ``LearnerTape`` records one PPO iteration of the trainer as it runs:
    the learner's state before it, every env step's outputs (the rollout's
    inputs to the learner), and every minibatch the trainer fed its Adam
    step with the parameters and moments just before that step.
    ``learner_reference`` replays the iteration from the tape: the
    observation normaliser, the policy's values and log-probabilities,
    dual-done GAE, the value and return normalisers, then each minibatch's
    clipped-surrogate loss, its gradient, the global-norm clip and the
    Adam step from the trainer's state before it, on the rows the trainer
    drew (found by their actions; each epoch's minibatches must cover the
    batch exactly once).
  * ``substep_reference`` is one physics substep from the definitions:
    the PD torque, the mass matrix and the bias forces from the kinetic
    and potential energy (Lagrange's equations, by automatic
    differentiation of the bodies' positions, not by the engine's
    Newton-Euler terms), the contact points' Jacobians, the impulse's
    velocity change, the exponential-map integration and the joint-limit
    clamp. The contact frames and impulses are its inputs: the solve is
    held against its plain version elsewhere.

Both compute in float64 and take ``rounded``: every floating input
rounded through bfloat16 first, the control reading of a program that
carried its data at that precision.

Imports torch and numpy only; the model enters as data (a RobotModel's
arrays), the network as its named parameters.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp, vmap

G = 9.81
F64 = torch.float64
CHUNK = 4096          # envs a vmapped call of the physics reference takes
OBS_EPS = 1e-8        # the normalisers' variance epsilon
ADV_EPS = 1e-8        # the advantage normalisation's epsilon
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-5
# a row whose clip decision (the policy ratio at 1 +- clip, the value's
# clamp or its larger square) lies this near its boundary may fall either
# way in float32 (the ratio's rounding there is ~1e-6)
CLIP_MARGIN = 1e-4


class Mismatch(Exception):
    """The tape does not hold the iteration the reference replays: a
    minibatch row that is not in the rollout, or epochs that do not cover
    the batch once."""


def _cast(rounded: bool):
    def cast(t):
        t = t.detach()
        if rounded and t.is_floating_point():
            t = t.to(torch.bfloat16)
        return t.to(F64) if t.is_floating_point() else t
    return cast


F32_ULP = float(torch.finfo(torch.float32).eps)


def relative_err(port, ref, scale=None, stored: bool = False,
                 allow=None) -> float:
    """max |port - ref| / max |scale| (``scale`` defaults to ``ref``). With
    ``stored``, one float32 ulp of ``ref`` is allowed first: the program
    keeps these values in float32 (positions tens of metres from the
    origin, weights of order 1 moved by 3e-4 a step), so it cannot come
    nearer than its storage's resolution. ``allow`` (elementwise) is
    allowed too."""
    ref = ref.double()
    s = (ref if scale is None else scale.double()).abs().max().item()
    err = (port.double() - ref).abs()
    if stored:
        err = torch.clamp(err - F32_ULP * ref.abs(), min=0.0)
    if allow is not None:
        err = torch.clamp(err - allow, min=0.0)
    return err.max().item() / max(s, 1e-30)


# ---------------------------------------------------------------- learner

class LearnerTape:
    """On for one PPO iteration launched from the host
    (``ppo._train_iteration_eager``: the same bodies the graphed iteration
    captures, with each step called where the tape sees it): records the
    learner's state before it, each ``env.step``'s (action, raw next obs,
    reward, done, time-out), and for each ``ppo.sgd_step``
    its minibatch, its advantage moments, the parameters and Adam moments
    just before it and the clipped gradient it stepped with; then the
    parameters after the iteration."""

    def __init__(self, env, ppo):
        self.env, self.ppo = env, ppo

    def __enter__(self):
        env, ppo = self.env, self.ppo
        clone = lambda t: t.detach().clone()  # noqa: E731
        self.obs_rms0 = tuple(clone(t) for t in ppo.obs_rms)
        self.value_rms0 = tuple(clone(t) for t in ppo.value_rms)
        self.obs0, self.done0, self.tdone0 = (
            clone(ppo.next_obs), clone(ppo.next_done),
            clone(ppo.next_true_done))
        self.theta0 = {k: clone(p) for k, p in ppo.net.named_parameters()}
        self.iteration = ppo.iteration
        self.steps, self.minibatches, self.before, self.grads = [], [], [], []
        step, sgd = env.step, ppo.sgd_step

        def taped_step(es, action, gen):
            out = step(es, action, gen)
            _, raw, reward, done, time_out = out
            self.steps.append(tuple(clone(t) for t in (
                action, raw, reward, done, time_out)))
            return out

        def taped_sgd(mb, adv_mom, *a, **k):
            self.minibatches.append(([clone(x) for x in mb], clone(adv_mom)))
            state = {}
            for name, p in ppo.net.named_parameters():
                st = ppo.opt.state.get(p, {})
                state[name] = (clone(p), *(
                    (clone(st["exp_avg"]), clone(st["exp_avg_sq"]),
                     float(st["step"])) if st else
                    (torch.zeros_like(p), torch.zeros_like(p), 0.0)))
            self.before.append(state)
            out = sgd(mb, adv_mom, *a, **k)
            self.grads.append({name: clone(p.grad)
                               for name, p in ppo.net.named_parameters()})
            return out

        env.step, ppo.sgd_step = taped_step, taped_sgd
        return self

    def __exit__(self, *exc):
        del self.env.step, self.ppo.sgd_step
        self.theta1 = {k: p.detach().clone()
                       for k, p in self.ppo.net.named_parameters()}

    def after(self, i: int):
        """The parameters after the i-th Adam step."""
        if i + 1 < len(self.before):
            return {k: v[0] for k, v in self.before[i + 1].items()}
        return self.theta1


def _mlp(theta, prefix: str, x):
    i = 0
    while f"{prefix}.{i + 1}.weight" in theta:
        x = torch.nn.functional.elu(x @ theta[f"{prefix}.{i}.weight"].T
                                    + theta[f"{prefix}.{i}.bias"])
        i += 1
    return x @ theta[f"{prefix}.{i}.weight"].T + theta[f"{prefix}.{i}.bias"]


def _policy(theta, obs):
    """(action mean, log std, value) of the separate actor and critic."""
    return (_mlp(theta, "actor.layers", obs), theta["log_std"],
            _mlp(theta, "critic.layers", obs)[..., 0])


def _logp(mean, log_std, act):
    z = (act - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi), -1)


def _pool(state, x):
    """Pool a (mean, var, count) running estimate with the rows of x: the
    mean and variance of the union, counted with the prior's weight."""
    mean, var, count = state
    n = float(x.shape[0])
    bmean, bvar = x.mean(0), x.var(0, unbiased=False)
    tot = count + n
    new_mean = (count * mean + n * bmean) / tot
    new_var = (count * var + n * bvar
               + (bmean - mean) ** 2 * count * n / tot) / tot
    return new_mean, new_var, tot


def _normalise(state, x):
    return (x - state[0]) / torch.sqrt(state[1] + OBS_EPS)


class LearnerResult(NamedTuple):
    grads: List[Dict[str, torch.Tensor]]    # each step's clipped gradient
    allow: List[Dict[str, torch.Tensor]]    # and what its rows at a clip
                                            # boundary may move it by
    thetas: List[Dict[str, torch.Tensor]]   # each step's Adam update of
                                            # the trainer's gradient
    batch: List[torch.Tensor]            # obs, act, logp, adv, ret, val rows
    rows: List[torch.Tensor]             # each minibatch's row indices
    adv_moms: List[torch.Tensor]
    ambiguous: int                       # rows at a clip boundary, in all


def _at_clip_boundary(ratio, vn, old_v, ret, v_clip, clip):
    """(policy rows, value rows) whose clip decision lies within
    CLIP_MARGIN of its boundary: the ratio at 1 +- clip; the value's step
    from its old value at +-clip, or, outside the clip band, its two
    squared errors at a tie."""
    def near(x, at, tol):
        return (x - at).abs() < tol

    pol = near(ratio, 1 + clip, CLIP_MARGIN) | near(ratio, 1 - clip,
                                                    CLIP_MARGIN)
    dv, tol = vn - old_v, CLIP_MARGIN * (1 + vn.abs())
    sq, sq_c = (vn - ret) ** 2, (v_clip - ret) ** 2
    val = (near(dv, clip, tol) | near(dv, -clip, tol)
           | ((dv.abs() > clip) & near(sq, sq_c, CLIP_MARGIN
                                      * (1 + sq + sq_c))))
    return pol, val


def _flip_allowance(params, names, value_rms, cfg, n, pol_rows, val_rows,
                    g_raw):
    """Per entry, the most the rows at a clip boundary can move the
    clipped gradient by falling the other way. A policy row's surrogate
    has the gradient of adv x ratio or none; a value row's loss that of
    vf x (v - ret)^2 / 2 or none (its clamped branch); each over the
    minibatch, summed in absolute value: A. The raw gradient ``g_raw``
    may then move by A, its norm by at most |A|, and the global-norm
    clip's scale s = min(1, max_norm / |g|) by the share
    r = |A| / (|g| - |A|) of itself; so an entry of the clipped gradient
    by s A + r |s g|."""
    def pol(p, o, a, old_logp, ad):
        mean, log_std, _ = _policy(dict(zip(names, p)), o[None])
        return (ad * torch.exp(_logp(mean, log_std, a[None]) - old_logp))[0]

    def val(p, o, r):
        v = _normalise(value_rms, _policy(dict(zip(names, p)), o[None])[2])
        return (0.5 * cfg.vf_coef * (v - r) ** 2)[0]

    A = [torch.zeros_like(p) for p in params]
    for fn, rows in ((pol, pol_rows), (val, val_rows)):
        if rows[0].shape[0]:
            per_row = vmap(grad(fn), in_dims=(None,) + (0,) * len(rows))(
                tuple(params), *rows)
            A = [t + g.abs().sum(0) / n for t, g in zip(A, per_row)]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in g_raw))
    a_norm = torch.sqrt(sum(torch.sum(a * a) for a in A))
    M = cfg.max_grad_norm
    s = torch.clamp(M / norm, max=1.0)
    r = (a_norm / torch.clamp(norm - a_norm, min=M) if norm + a_norm > M
         else torch.zeros_like(norm))
    return {k: s * a + r * s * g.abs() for k, a, g in zip(names, A, g_raw)}


def learner_reference(tape: LearnerTape, cfg,
                      rounded: bool = False) -> LearnerResult:
    """The iteration on the tape, from the definitions (clean_rl recipe:
    separate actor and critic, linear learning-rate anneal, no timeout
    bootstrap)."""
    if (cfg.resolved_lr_mode != "linear" or cfg.shared_model
            or cfg.value_bootstrap):
        raise ValueError("the learner reference implements the clean_rl "
                         "recipe only")
    c = _cast(rounded)
    theta = {k: c(v) for k, v in tape.theta0.items()}
    obs_rms = tuple(c(t) for t in tape.obs_rms0)
    obs, done, tdone = c(tape.obs0), c(tape.done0), c(tape.tdone0)
    cols = {k: [] for k in ("obs", "act", "logp", "val", "rew", "done",
                            "tdone")}
    with torch.no_grad():
        for act, raw, rew, next_done, time_out in tape.steps:
            act = c(act)
            mean, log_std, val = _policy(theta, obs)
            for k, v in zip(cols, (obs, act, _logp(mean, log_std, act), val,
                                   c(rew), done, tdone)):
                cols[k].append(v)
            obs_rms = _pool(obs_rms, c(raw))
            obs = _normalise(obs_rms, c(raw))
            done, tdone = c(next_done), c(time_out.to(torch.float32))
        next_value = _policy(theta, obs)[2]
    b = {k: torch.stack(v) for k, v in cols.items()}
    # dual-done GAE: step t bootstraps through (1 - done) (1 - tdone) of
    # step t + 1
    adv = torch.zeros_like(b["rew"])
    carry = torch.zeros_like(next_value)
    nxt_val, nxt_live = next_value, (1 - done) * (1 - tdone)
    for t in reversed(range(b["rew"].shape[0])):
        delta = b["rew"][t] + cfg.gamma * nxt_val * nxt_live - b["val"][t]
        carry = delta + cfg.gamma * cfg.gae_lambda * nxt_live * carry
        adv[t] = carry
        nxt_val = b["val"][t]
        nxt_live = (1 - b["done"][t]) * (1 - b["tdone"][t])
    ret = adv + b["val"]
    flat = lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])  # noqa
    val, ret, adv = flat(b["val"]), flat(ret), flat(adv)
    value_rms = _pool(tuple(c(t) for t in tape.value_rms0), val)
    val_n = _normalise(value_rms, val)
    value_rms = _pool(value_rms, ret)
    ret_n = _normalise(value_rms, ret)
    batch = [flat(b["obs"]), flat(b["act"]), flat(b["logp"]), adv, ret_n,
             val_n]

    # the rows of each taped minibatch, found by their actions (the tape's
    # own values: a row's key is the bits of its first two actions, and
    # the whole row must then match), and each epoch's minibatches must
    # hold every row once
    acts = torch.stack([s[0] for s in tape.steps]).flatten(0, 1)

    def key(a):
        bits = a[:, :2].contiguous().view(torch.int32).long()
        return (bits[:, 0] << 32) | (bits[:, 1] & 0xFFFFFFFF)

    keys, order = torch.sort(key(acts))
    rows = []
    for mb, _ in tape.minibatches:
        at = torch.searchsorted(keys, key(mb[1])).clamp(max=len(keys) - 1)
        idx = order[at]
        if not torch.equal(acts[idx], mb[1]):
            raise Mismatch("a minibatch row is not in the rollout")
        rows.append(idx)
    nb = acts.shape[0]
    n_mb = nb // cfg.minibatch_size
    if (len(rows) != cfg.updates_epochs * n_mb
            or n_mb * cfg.minibatch_size != nb):
        raise Mismatch(f"{len(rows)} minibatch steps, expected "
                       f"{cfg.updates_epochs} epochs x {n_mb} of "
                       f"{cfg.minibatch_size} rows over {nb}")
    for e in range(cfg.updates_epochs):
        seen = torch.sort(torch.cat(rows[e * n_mb:(e + 1) * n_mb])).values
        if not torch.equal(seen, torch.arange(nb, device=seen.device)):
            raise Mismatch(f"epoch {e}'s minibatches do not cover the "
                           f"batch once")

    # each step from the trainer's own parameters and moments just before
    # it, in two parts: the clipped gradient, and the Adam update of the
    # trainer's own gradient. Neither carries the rounding of earlier
    # steps: the clipped surrogate is not smooth, so a replay of the whole
    # epoch would move rows across the clip and drift by more than a
    # fault; and Adam divides each entry's step by its own second moment,
    # so one entry's gradient rounding can be a large share of its step
    lr = cfg.learning_rate * max(1.0 - tape.iteration / cfg.num_iterations,
                                 0.0)
    b1, b2 = ADAM_BETAS
    grads, allow, thetas, adv_moms, ambiguous = [], [], [], [], 0
    for idx, state, g_tape in zip(rows, tape.before, tape.grads):
        o, a, old_logp, ad, r, old_v = (x[idx] for x in batch)
        mom = torch.stack([ad.mean(), (ad * ad).mean()])
        adv_moms.append(mom)
        std = torch.sqrt(torch.clamp(mom[1] - mom[0] ** 2, min=0.0))
        ad = (ad - mom[0]) / (std + ADV_EPS)
        names = list(state)
        params = [c(state[k][0]).requires_grad_(True) for k in names]
        mean, log_std, value = _policy(dict(zip(names, params)), o)
        ratio = torch.exp(_logp(mean, log_std, a) - old_logp)
        pg = torch.mean(torch.maximum(
            -ad * ratio,
            -ad * torch.clamp(ratio, 1 - cfg.clip_coef, 1 + cfg.clip_coef)))
        vn = _normalise(value_rms, value)
        v_clip = old_v + torch.clamp(vn - old_v, -cfg.clip_coef, cfg.clip_coef)
        v_loss = 0.5 * torch.mean(torch.maximum((vn - r) ** 2,
                                                 (v_clip - r) ** 2))
        entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
        loss = pg - cfg.ent_coef * entropy + cfg.vf_coef * v_loss
        g = torch.autograd.grad(loss, params)
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        scale = torch.clamp(cfg.max_grad_norm / norm, max=1.0)
        grads.append({k: x * scale for k, x in zip(names, g)})
        pol, val = _at_clip_boundary(ratio.detach(), vn.detach(), old_v, r,
                                     v_clip.detach(), cfg.clip_coef)
        ambiguous += int(pol.sum()) + int(val.sum())
        allow.append(_flip_allowance(
            [p.detach() for p in params], names, value_rms, cfg, len(idx),
            (o[pol], a[pol], old_logp[pol], ad[pol]), (o[val], r[val]), g))
        theta = {}
        for k in names:
            p, m, v, step = state[k]
            gk = c(g_tape[k])
            m = b1 * c(m) + (1 - b1) * gk
            v = b2 * c(v) + (1 - b2) * gk * gk
            m_hat = m / (1 - b1 ** (step + 1))
            v_hat = v / (1 - b2 ** (step + 1))
            theta[k] = c(p) - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
        thetas.append(theta)
    return LearnerResult(grads, allow, thetas, batch, rows, adv_moms,
                         ambiguous)


def learner_errors(tape: LearnerTape, ref: LearnerResult,
                   against: LearnerResult = None) -> Dict[str, float]:
    """The trainer's iteration on the tape (or ``against``, another
    reference run) against the reference ``ref``, each the largest over
    the Adam steps: ``batch``, the error of a minibatch field
    (observation, log-probability, advantage, normalised return and
    value) or advantage moment over that field's largest magnitude;
    ``grads``, the error of the clipped gradient (beyond what its rows at
    a clip boundary may move it by) over each tensor's largest entry;
    ``adam``, the error of the parameters after the step
    (beyond one float32 ulp: they are stored in float32) over each
    tensor's largest change in it."""
    batch = grads = adam = 0.0
    for i, idx in enumerate(ref.rows):
        got = (tape.minibatches[i][0] if against is None
               else [x[against.rows[i]] for x in against.batch])
        mom = (tape.minibatches[i][1] if against is None
               else against.adv_moms[i])
        for f in (0, 2, 3, 4, 5):
            batch = max(batch, relative_err(got[f], ref.batch[f][idx],
                                            ref.batch[f]))
        batch = max(batch, relative_err(mom, ref.adv_moms[i]))
        g = tape.grads[i] if against is None else against.grads[i]
        theta = tape.after(i) if against is None else against.thetas[i]
        for k, t in ref.thetas[i].items():
            grads = max(grads, relative_err(g[k], ref.grads[i][k],
                                            allow=ref.allow[i][k]))
            adam = max(adam, relative_err(
                theta[k], t, t - tape.before[i][k][0].double(), stored=True))
    return {"batch": batch, "grads": grads, "adam": adam}


# ---------------------------------------------------------------- physics

def _skew(v):
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def _rot(axis, angle):
    """Rotation by ``angle`` about the unit ``axis`` (Rodrigues)."""
    K = _skew(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return (eye + torch.sin(angle)[..., None, None] * K
            + (1 - torch.cos(angle))[..., None, None] * (K @ K))


def _rot_of_vector(w):
    """exp(skew(w)) for any w, zero included."""
    angle = torch.linalg.vector_norm(w, dim=-1)
    axis = w / torch.clamp(angle, min=1e-300)[..., None]
    return _rot(axis, angle)


def _quat_matrix(q):
    w, x, y, z = (q / torch.linalg.vector_norm(q, dim=-1,
                                               keepdim=True)).unbind(-1)
    return torch.stack([
        torch.stack([w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), w * w - x * x + y * y - z * z,
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     w * w - x * x - y * y + z * z], -1)], -2)


class _Tree(NamedTuple):
    parent: tuple
    joint_pos: torch.Tensor
    joint_rot: torch.Tensor
    axis: torch.Tensor
    mass: torch.Tensor
    com: torch.Tensor
    second_moment: torch.Tensor    # sum rho r r^T about the com, body frame
    armature: torch.Tensor


def _tree(model, device) -> _Tree:
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=F64,  # noqa: E731
                                  device=device)
    inertia = t(model.inertia)
    tr = inertia.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=F64, device=device)
    return _Tree(tuple(int(p) for p in model.parent), t(model.joint_pos),
                 t(model.joint_rot), t(model.joint_axis), t(model.mass),
                 t(model.com), 0.5 * tr[:, None, None] * eye - inertia,
                 t(model.armature))


def _frames(tree: _Tree, base_p, base_R, qj):
    """World origins and rotations of the bodies: a body's frame is its
    parent's, moved to the joint origin, turned by the joint's rotation,
    then by the joint angle about its axis."""
    o, R = [base_p], [base_R]
    for b in range(1, len(tree.parent)):
        p = tree.parent[b]
        o.append(o[p] + R[p] @ tree.joint_pos[b])
        R.append(R[p] @ tree.joint_rot[b] @ _rot(tree.axis[b], qj[b - 1]))
    return torch.stack(o), torch.stack(R)


def _chart(tree, p0, R0, qj0, d):
    """Body frames at configuration (p0, R0, qj0) moved by the tangent
    vector d: base translation (world), base rotation (body frame; exp to
    second order, exact for derivatives up to the second at d = 0),
    joint angles."""
    K = _skew(d[3:6])
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    return _frames(tree, p0 + d[0:3], R0 @ (eye + K + 0.5 * K @ K),
                   qj0 + d[6:])


def _env_dynamics(tree, p0, R0, qj0, v, com):
    """One env: the mass matrix M and the bias C (Coriolis, centrifugal,
    gravity) at velocity v, from Lagrange's equations in the chart:
    M = d2T/dv2, C = (dM/dq v) v - dT/dq + dV/dq."""
    nv = v.shape[0]

    def coms(d):
        o, R = _chart(tree, p0, R0, qj0, d)
        return o + (R @ com[..., None])[..., 0], R

    def energy(d, dd):
        (x, R), (xd, Rd) = jvp(coms, (d,), (dd,))
        trans = 0.5 * torch.sum(tree.mass * torch.sum(xd * xd, -1))
        rot = 0.5 * torch.sum(Rd * (Rd @ tree.second_moment))
        return trans + rot + 0.5 * torch.sum(tree.armature * dd[6:] ** 2)

    def potential(d):
        return G * torch.sum(tree.mass * coms(d)[0][:, 2])

    zero = torch.zeros(nv, dtype=v.dtype, device=v.device)
    momentum = grad(energy, argnums=1)
    M = jacfwd(momentum, argnums=1)(zero, v)
    Mdot_v = jvp(lambda d: momentum(d, v), (zero,), (v,))[1]
    C = Mdot_v - grad(energy, argnums=0)(zero, v) + grad(potential)(zero)
    return M, C


def _env_jacobians(tree, p0, R0, qj0, cand_body, cand_r, pair_body_a,
                   pair_r_a, pair_body_b, pair_r_b):
    """One env: the world Jacobians (k, 3, nv) of the terrain candidates'
    centres and of the pairs' relative closest points."""
    zero = torch.zeros(6 + qj0.shape[0], dtype=p0.dtype, device=p0.device)

    def points(d, body, r):
        o, R = _chart(tree, p0, R0, qj0, d)
        return o[body] + (R[body] @ r[..., None])[..., 0]

    Jc = jacfwd(points)(zero, cand_body, cand_r)
    Jp = (jacfwd(points)(zero, pair_body_a, pair_r_a)
          - jacfwd(points)(zero, pair_body_b, pair_r_b))
    return torch.cat([Jc, Jp])


def _chunked(fn, *args):
    """fn over envs [i, i + CHUNK) of the (batched) args; its outputs (a
    tuple) concatenated."""
    outs = [fn(*(x[i:i + CHUNK] for x in args))
            for i in range(0, args[0].shape[0], CHUNK)]
    return tuple(torch.cat(x) for x in zip(*outs))


def mass_and_bias(model, qpos, qvel, com_offset=None):
    """(M (N, nv, nv), C (N, nv)) of ``model`` at (qpos, qvel), in
    float64."""
    tree = _tree(model, qpos.device)
    qpos, qvel = qpos.to(F64), qvel.to(F64)
    com = tree.com.expand(qpos.shape[0], -1, -1)
    if com_offset is not None:
        com = com + com_offset.to(F64)
    fn = vmap(lambda *a: _env_dynamics(tree, *a))
    return _chunked(fn, qpos[:, 0:3], _quat_matrix(qpos[:, 3:7]),
                    qpos[:, 7:], qvel, com)


def _closest(p0a, p1a, p0b, p1b):
    """Closest points of segments a and b (Ericson, Real-Time Collision
    Detection 5.1.9)."""
    d1, d2, r = p1a - p0a, p1b - p0b, p0a - p0b
    a, e = torch.sum(d1 * d1, -1), torch.sum(d2 * d2, -1)
    b, c, f = (torch.sum(d1 * d2, -1), torch.sum(d1 * r, -1),
               torch.sum(d2 * r, -1))
    denom = a * e - b * b
    s = torch.where(denom > 1e-12 * a * e,
                    torch.clamp((b * f - c * e) / denom, 0, 1),
                    torch.zeros_like(a))
    t = (b * s + f) / e
    s = torch.where(t < 0, torch.clamp(-c / a, 0, 1),
                    torch.where(t > 1, torch.clamp((b - c) / a, 0, 1), s))
    t = torch.clamp(t, 0, 1)
    return p0a + s[..., None] * d1, p0b + t[..., None] * d2


class SubstepRef(NamedTuple):
    qvel: torch.Tensor        # (N, nv)
    base_pos: torch.Tensor    # (N, 3)
    base_R: torch.Tensor      # (N, 3, 3)
    qj: torch.Tensor          # (N, nj)
    E: torch.Tensor           # (N, 3 nc, nv) contact rows
    b: torch.Tensor           # (N, 3 nc) contact rows' free velocity


def substep_reference(model, dt: float, kp: float, kd: float, qpos, qvel,
                      target, frame, lam, com_offset=None,
                      rounded: bool = False) -> SubstepRef:
    """One substep of ``model`` at (qpos, qvel) under PD ``target``, with
    the contact impulses ``lam`` (N, 3 nc) in the contact ``frame``s (N,
    nc, 3, 3) rows (t1, t2, n), or None for the world frame."""
    c = _cast(rounded)
    dev = qpos.device
    tree = _tree(model, dev)
    qpos, qvel, target, lam = c(qpos), c(qvel), c(target), c(lam)
    n, nv = qvel.shape
    nc = lam.shape[1] // 3
    frame = (torch.eye(3, dtype=F64, device=dev).expand(n, nc, 3, 3)
             if frame is None else c(frame))
    com_offset = None if com_offset is None else c(com_offset)
    p0, qj0 = qpos[:, 0:3], qpos[:, 7:]
    R0 = _quat_matrix(qpos[:, 3:7])

    # the capsule pairs' closest points, as body-frame points of each side
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=F64,  # noqa: E731
                                  device=dev)
    o, R = vmap(lambda p, Rb, q: _frames(tree, p, Rb, q))(p0, R0, qj0)
    ba = torch.as_tensor(np.asarray(model.pair_body_a), device=dev).long()
    bb = torch.as_tensor(np.asarray(model.pair_body_b), device=dev).long()

    def world(body, x):
        return o[:, body] + (R[:, body] @ t(x)[..., None])[..., 0]

    ca, cb = _closest(world(ba, model.pair_p0_a), world(ba, model.pair_p1_a),
                      world(bb, model.pair_p0_b), world(bb, model.pair_p1_b))
    ra = (R[:, ba].transpose(-1, -2) @ (ca - o[:, ba])[..., None])[..., 0]
    rb = (R[:, bb].transpose(-1, -2) @ (cb - o[:, bb])[..., None])[..., 0]
    cand_body = torch.as_tensor(np.asarray(model.cand_body), device=dev).long()
    cand_r = t(model.cand_offset)

    M, C = mass_and_bias(model, qpos, qvel, com_offset)
    jac = vmap(lambda p, Rb, q, r_a, r_b: (_env_jacobians(
        tree, p, Rb, q, cand_body, cand_r, ba, r_a, bb, r_b),))
    J, = _chunked(jac, p0, R0, qj0, ra, rb)

    effort = t(model.effort_limit)
    tau_j = torch.clamp(kp * (target - qj0) - kd * qvel[:, 6:], -effort, effort)
    tau = torch.cat([torch.zeros_like(qvel[:, :6]), tau_j], 1)
    E = (frame @ J).reshape(n, 3 * nc, nv)
    v_free = qvel + dt * torch.linalg.solve(M, tau - C)
    v_new = v_free + torch.linalg.solve(M, (E.transpose(1, 2)
                                            @ lam[..., None])[..., 0])
    qj = qj0 + dt * v_new[:, 6:]
    qj_c = torch.clamp(qj, t(model.joint_limit_lower),
                       t(model.joint_limit_upper))
    v_new = torch.cat([v_new[:, :6],
                       torch.where(qj_c != qj, 0.0, v_new[:, 6:])], 1)
    return SubstepRef(
        qvel=v_new, base_pos=p0 + dt * v_new[:, 0:3],
        base_R=R0 @ _rot_of_vector(dt * v_new[:, 3:6]), qj=qj_c,
        E=E, b=(E @ v_free[..., None])[..., 0])


def substep_errors(before, after, ops, ref: SubstepRef) -> Dict[str, float]:
    """A substep of the program (its state ``before`` and ``after``, its
    contact operands ``ops``) against the reference: velocities over their
    largest magnitude, each position (beyond one float32 ulp) over its
    largest change in the substep, the contact rows of the active contacts
    over the largest entry."""
    active = ops[4].bool().repeat_interleave(3, dim=1)
    q0, q1 = before.qpos.double(), after.qpos.double()
    R1 = _quat_matrix(q1[:, 3:7])
    R0 = _quat_matrix(q0[:, 3:7])
    E, b = ops[0].double(), ops[2].double()
    return {
        "qvel": relative_err(after.qvel, ref.qvel),
        "base_pos": relative_err(q1[:, 0:3], ref.base_pos,
                                 ref.base_pos - q0[:, 0:3], stored=True),
        "base_rot": relative_err(R1, ref.base_R, ref.base_R - R0,
                                 stored=True),
        "joints": relative_err(q1[:, 7:], ref.qj, ref.qj - q0[:, 7:],
                               stored=True),
        "contact_rows": relative_err(E[active], ref.E[active], ref.E[active])
        if bool(active.any()) else 0.0,
        "contact_b": relative_err(b[active], ref.b[active])
        if bool(active.any()) else 0.0,
    }
