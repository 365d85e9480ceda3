"""The plain reference of a TreeCSS job and of a SplitNN's scores.

Plain NumPy and PyTorch, written from the paper and the job's
configuration; it imports nothing of the system under test.  Two uses:

- ``judge_job`` holds one job that the program ran (its ``record``:
  the intersection, the k-means fit stage by stage, the coreset, the
  training losses and trained parameters, the evaluation's raw
  outputs) against the reference, stage by stage.  The id lists, the
  intersection and the aligned rows the reference works out alone.  The
  fit it follows step by step from the program's own state (each Lloyd
  step from the centroids the program's previous step produced), since
  an f32 fit and an f64 one part for good at the first near tie of two
  distances; the start (the k-means++ draws) is checked by itself.
  Selection and weighting are exact functions of the fit's
  assignments and distances, recomputed from the program's.  Training
  runs again in f64 from the same initial parameters on the rows and
  weights the program selected, for as many epochs as the program ran;
  evaluation runs again in f64 with the program's trained parameters.
  That the program did all of the job's work (as many Lloyd steps as
  the configuration states, and training stopped where the paper's rule
  stops it on the reference's losses) is checked apart.
- ``run_job`` runs a whole job the reference's way in a given dtype;
  in bfloat16 it is the control that the comparison has to reject.

``predict`` is also the reference of the scoring engine's answers.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import threefry
from perfbench.reference.data import Partitions, make_id_universe

__all__ = ["align", "job_settings", "n_out", "init_params", "forward", "train",
           "predict", "params_numpy", "rank_weights", "select", "run_job",
           "judge_job"]

_ROWS = 1 << 15          # rows a block of the f64 distance computation


# ------------------------------------------------------------- alignment


def align(sets: Sequence[np.ndarray]):
    """(intersection, sorted; rows of the label owner's list, client 0,
    whose ids lie in it, ascending)."""
    inter = np.asarray(sets[0])
    for s in sets[1:]:
        inter = np.intersect1d(inter, s)
    rows = np.flatnonzero(np.isin(sets[0], inter))
    return np.sort(inter), rows


def job_ids(config: dict, n_rows: int, job_seed: int):
    """The job's id lists, as the configuration's overlap draws them."""
    sets, _ = make_id_universe(int(config["split"]["clients"]), n_rows,
                               float(config["align"]["overlap"]), job_seed)
    return sets


# ----------------------------------------------------------- the SplitNN


def job_settings(config: dict, job_seed: int) -> dict:
    """The SplitNN settings of a job: the configuration's ``model``
    with batches of ``max(min_batch, train rows // batch_divisor)`` rows
    (Table 2's rule) and the job's seed."""
    mdl = dict(config["model"])
    n_rows = int(int(config["dataset"]["n_instances"])
                 * float(config["split"]["train_fraction"]))
    mdl["batch_size"] = max(int(mdl["min_batch"]),
                            n_rows // int(mdl["batch_divisor"]))
    mdl["seed"] = int(job_seed)
    return mdl


def n_out(mdl: dict) -> int:
    """The width of the model's output."""
    c = int(mdl["n_classes"])
    if mdl["model"] in ("lr", "linreg"):
        return 1 if mdl["model"] == "linreg" or c == 2 else max(c, 1)
    return c if c > 2 else 1


def init_params(mdl: dict, feature_dims: Sequence[int]) -> dict:
    """The initial parameters, numpy f32: threefry normals from the
    job's seed, scaled by fan-in (lr/linreg bottoms by a further 0.1),
    zero biases."""
    f32 = np.float32
    m = len(feature_dims)
    ks = threefry.split(threefry.PRNGKey(int(mdl["seed"])), m + 2)
    width = n_out(mdl)
    if mdl["model"] in ("lr", "linreg"):
        bottoms = [{"w": np.asarray(threefry.normal(ks[i], (d, width))
                                    * f32(d ** -0.5) * f32(0.1), f32)}
                   for i, d in enumerate(feature_dims)]
        return {"bottoms": bottoms, "top": {"b": np.zeros(width, f32)}}
    bd, hd = int(mdl["bottom_dim"]), int(mdl["hidden_dim"])
    bottoms = [{"w": np.asarray(threefry.normal(ks[i], (d, bd))
                                * f32(d ** -0.5), f32),
                "b": np.zeros(bd, f32)} for i, d in enumerate(feature_dims)]
    top = {"w1": np.asarray(threefry.normal(ks[m], (m * bd, hd))
                            * f32((m * bd) ** -0.5), f32),
           "b1": np.zeros(hd, f32),
           "w2": np.asarray(threefry.normal(ks[m + 1], (hd, width))
                            * f32(hd ** -0.5), f32),
           "b2": np.zeros(width, f32)}
    return {"bottoms": bottoms, "top": top}


def _leaves(params: dict) -> List:
    out = []
    for bp in params["bottoms"]:
        out += [bp[k] for k in sorted(bp)]
    return out + [params["top"][k] for k in sorted(params["top"])]


def _to(params: dict, dtype, device) -> dict:
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                  device=device).to(dtype)
    return {"bottoms": [{k: t(v) for k, v in bp.items()}
                        for bp in params["bottoms"]],
            "top": {k: t(v) for k, v in params["top"].items()}}


def params_numpy(params: dict) -> dict:
    """Parameters of tensors as numpy f32 arrays, the same tree."""
    n = lambda t: t.detach().float().cpu().numpy()
    return {"bottoms": [{k: n(v) for k, v in bp.items()}
                        for bp in params["bottoms"]],
            "top": {k: n(v) for k, v in params["top"].items()}}


def forward(params: dict, model: str, xs: Sequence[torch.Tensor]
            ) -> torch.Tensor:
    """Outputs (B, o): each client's bottom on its own columns (ReLU
    with a bias for the mlp), the top model on their concatenation
    (mlp) or their sum plus a bias (lr/linreg)."""
    acts = []
    for bp, x in zip(params["bottoms"], xs):
        a = x @ bp["w"]
        if "b" in bp:
            a = torch.relu(a + bp["b"])
        acts.append(a)
    if model in ("lr", "linreg"):
        out = acts[0]
        for a in acts[1:]:
            out = out + a
        return out + params["top"]["b"]
    top = params["top"]
    h = torch.relu(torch.cat(acts, 1) @ top["w1"] + top["b1"])
    return h @ top["w2"] + top["b2"]


def _loss(out: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
          n_classes: int) -> torch.Tensor:
    """Eq. (2): Σ w·l / max(Σ w, 1e-12)."""
    if n_classes == 0:
        per = (out[:, 0] - y) ** 2
    elif n_classes == 2 and out.shape[1] == 1:
        per = F.binary_cross_entropy_with_logits(out[:, 0], y.to(out.dtype),
                                                 reduction="none")
    else:
        per = F.cross_entropy(out, y.long(), reduction="none")
    return (w * per).sum() / w.sum().clamp_min(1e-12)


def train(mdl: dict, xs: Sequence[np.ndarray], labels: np.ndarray,
          weights: Optional[np.ndarray], *, epochs: Optional[int],
          dtype=torch.float64, device="cpu"):
    """Adam on Eq. (2) from ``init_params``: every epoch a permutation
    from ``default_rng(seed)``, batches of ``batch_size`` rows (the last
    one short).  ``epochs`` fixes the count; ``None`` runs to the
    paper's rule (the loss changed by less than ``convergence_eps`` over
    ``convergence_window`` epochs) or ``max_epochs``.  Returns (epoch
    losses, trained parameters as numpy)."""
    dims = [x.shape[1] for x in xs]
    params = _to(init_params(mdl, dims), dtype, device)
    leaves = _leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    xs_d = [torch.as_tensor(x, device=device).to(dtype) for x in xs]
    n_classes = int(mdl["n_classes"])
    y_d = torch.as_tensor(labels, device=device)
    y_d = y_d.to(dtype) if n_classes == 0 else y_d
    n = xs[0].shape[0]
    w_d = (torch.ones(n, dtype=dtype, device=device) if weights is None
           else torch.as_tensor(np.asarray(weights, np.float32),
                                device=device).to(dtype))
    bs = min(int(mdl["batch_size"]), n)
    lr, b1, b2, eps = float(mdl["lr"]), 0.9, 0.999, 1e-8
    rng = np.random.default_rng(int(mdl["seed"]))
    losses: List[float] = []
    step = 0
    cap = int(mdl["max_epochs"]) if epochs is None else int(epochs)
    for _ in range(cap):
        order = torch.as_tensor(rng.permutation(n), device=device)
        total = 0.0
        n_steps = 0
        for s in range(0, n, bs):
            ib = order[s:s + bs]
            out = forward(params, mdl["model"], [x[ib] for x in xs_d])
            loss = _loss(out, y_d[ib], w_d[ib], n_classes)
            grads = torch.autograd.grad(loss, leaves)
            step += 1
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            with torch.no_grad():
                for p, g, m_, v_ in zip(leaves, grads, mu, nu):
                    m_.mul_(b1).add_(g * (1 - b1))
                    v_.mul_(b2).add_(g * g * (1 - b2))
                    p.sub_(lr * (m_ / bc1) / ((v_ / bc2).sqrt() + eps))
            total += float(loss.detach())
            n_steps += 1
        losses.append(total / n_steps)
        wlen = int(mdl["convergence_window"])
        if (epochs is None and len(losses) > wlen and abs(
                losses[-1 - wlen] - losses[-1]) < float(
                    mdl["convergence_eps"])):
            break
    return losses, params_numpy(params)


def predict(params_np: dict, model: str, xs: Sequence[np.ndarray], *,
            dtype=torch.float64, device="cpu") -> np.ndarray:
    """Raw outputs (N, o) of ``params_np`` on ``xs``, in blocks."""
    params = _to(params_np, dtype, device)
    n = xs[0].shape[0]
    outs = []
    with torch.no_grad():
        for s in range(0, n, _ROWS):
            xb = [torch.as_tensor(x[s:s + _ROWS], device=device).to(dtype)
                  for x in xs]
            outs.append(forward(params, model, xb).double().cpu().numpy())
    return (np.concatenate(outs) if outs
            else np.zeros((0, 1), np.float64))


# ------------------------------------------------------------- k-means


def _draws(key: np.ndarray, k: int, n: int):
    """k-means++'s key stream: the first centroid's row and the factors
    ``1 - u`` of the k - 1 D² draws."""
    key, sub = threefry.split(key)
    first = int(threefry.randint(sub, (), 0, n))
    factors = []
    for _ in range(k - 1):
        key, sub = threefry.split(key)
        factors.append(float(np.float32(1) - threefry.uniform(sub)))
    return first, factors


def _sqdist(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, k) squared distances, as differences, in blocks of rows."""
    return torch.cat([((p[s:s + _ROWS, None, :] - c[None]) ** 2).sum(-1)
                      for s in range(0, p.shape[0], _ROWS)])


def _kmeans(points: torch.Tensor, k: int, key: np.ndarray, iters: int):
    """Lloyd from k-means++ in ``points``' dtype, recorded the way the
    judge reads a fit: (init, [(next centroids, assignment)], final)."""
    n = points.shape[0]
    first, factors = _draws(key, k, n)
    cents = [points[first]]
    dists = ((points - points[first]) ** 2).sum(1)
    for f in factors:
        cum = torch.cumsum(dists / dists.sum(), 0)
        r = cum[-1:] * f
        idx = int(torch.searchsorted(cum, r).clamp_max(n - 1))
        cents.append(points[idx])
        dists = torch.minimum(dists, ((points - points[idx]) ** 2).sum(1))
    c = torch.stack(cents)
    init = c.float().cpu().numpy()
    p2 = (points * points).sum(1, keepdim=True)

    def assign(c):
        d = (p2 - 2 * points @ c.T + (c * c).sum(1)[None]).clamp_min(0)
        sqd, a = d.min(1)
        return a, sqd

    steps = []
    for _ in range(iters):
        a, sqd = assign(c)
        sums = torch.zeros_like(c).index_add_(0, a, points)
        counts = torch.bincount(a, minlength=k).to(points.dtype)
        far = points[int(torch.argmax(sqd))]
        new = torch.where((counts > 0)[:, None],
                          sums / counts.clamp_min(1)[:, None], far[None])
        steps.append((new.float().cpu().numpy(),
                      a.to(torch.int32).cpu().numpy()))
        c = new
    a, sqd = assign(c)
    final = (c.float().cpu().numpy(), a.to(torch.int32).cpu().numpy(),
             sqd.float().cpu().numpy())
    return init, steps, final


def rank_weights(assign: np.ndarray, sq_dist: np.ndarray,
                 k: int) -> np.ndarray:
    """Step 2: within each cluster, sorted by distance farthest first
    (ties by row), the i-th row weighs i / |cluster|: the nearest 1."""
    ed = np.sqrt(np.maximum(sq_dist, np.float32(0)))
    w = np.zeros(assign.shape[0], np.float64)
    for c in range(k):
        rows = np.flatnonzero(assign == c)
        order = rows[np.argsort(-ed[rows], kind="stable")]
        w[order] = np.arange(1, rows.size + 1) / rows.size
    return w.astype(np.float32)


def select(assigns: Sequence[np.ndarray], sq_dists: Sequence[np.ndarray],
           labels: np.ndarray, k: int, regression_bins: int = 16):
    """Steps 4-5: group rows by (every client's cluster, label; a
    regression label by its quantile bin), keep each group's row of the
    least summed distance (ties by row), weigh it by its clients'
    weights summed.  Returns (rows ascending, weights f32)."""
    if np.issubdtype(labels.dtype, np.floating):
        qs = np.quantile(labels, np.linspace(0, 1, regression_bins + 1)[1:-1])
        lab = np.searchsorted(qs, labels).astype(np.int64)
    else:
        lab = labels.astype(np.int64)
    code = lab.copy()
    for a in assigns:
        code = code * k + a.astype(np.int64)
    _, group = np.unique(code, return_inverse=True)
    eds = [np.sqrt(np.maximum(s, np.float32(0))) for s in sq_dists]
    agg = eds[0].copy()
    for e in eds[1:]:
        agg = agg + e
    order = np.lexsort((np.arange(agg.size), agg, group))
    keep = np.ones(order.size, bool)
    keep[1:] = group[order][1:] != group[order][:-1]
    rows = np.sort(order[keep])
    ws = [rank_weights(a, s, k) for a, s in zip(assigns, sq_dists)]
    wsum = ws[0][rows].copy()
    for w in ws[1:]:
        wsum = wsum + w[rows]
    return rows.astype(np.int64), wsum.astype(np.float32)


# ----------------------------------------------------------- a whole job


def run_job(parts: Partitions, config: dict, job_seed: int, variant: str,
            *, dtype=torch.float64, device="cpu") -> dict:
    """A whole job the reference's way, in ``dtype`` throughout: the
    record ``judge_job`` reads.  In bfloat16 this is the control."""
    n = parts.train[0].shape[0]
    sets = job_ids(config, n, job_seed)
    inter, rows = align(sets)
    feats = [f[rows] for f in parts.train]
    labels = parts.train_labels[rows]
    mdl = job_settings(config, job_seed)
    rec = {"job_seed": int(job_seed), "intersection": inter,
           "kmeans": None, "coreset": None}
    weights = None
    if variant.endswith("css"):
        k = int(config["coreset"]["clusters_per_client"])
        iters = int(config["coreset"]["kmeans_iters"])
        fits = [_kmeans(torch.as_tensor(f, device=device).to(dtype), k,
                        threefry.PRNGKey(job_seed + 17 * i), iters)
                for i, f in enumerate(feats)]
        rec["kmeans"] = {
            "init": [f[0] for f in fits],
            "steps": [[f[1][t] for f in fits] for t in range(iters)],
            "final": [f[2] for f in fits]}
        idx, w = select([f[2][1] for f in fits], [f[2][2] for f in fits],
                        labels, k)
        rec["coreset"] = (idx, w)
        feats = [f[idx] for f in feats]
        labels = labels[idx]
        weights = w if config["coreset"]["use_weights"] else None
    losses, params = train(mdl, feats, labels, weights, epochs=None,
                           dtype=dtype, device=device)
    rec["losses"] = losses
    rec["params"] = params
    rec["eval_out"] = predict(params, mdl["model"], parts.test,
                              dtype=dtype, device=device).astype(np.float32)
    return rec


# ------------------------------------------------------------- the judge


def _init_gap(points32: np.ndarray, init: np.ndarray, key: np.ndarray,
              device) -> float:
    """How far a k-means++ seeding lies from its draws: the first
    centroid must be the row ``randint`` names, each further one a row
    whose share of the f64 cumulative D² mass holds ``(1 - u)`` of the
    total; the gap is the largest distance, as a share of that mass, by
    which a draw misses its row's interval (1 for a centroid that is no
    row at all)."""
    n, k = points32.shape[0], init.shape[0]
    first, factors = _draws(key, k, n)
    p = torch.as_tensor(points32, device=device)
    c = torch.as_tensor(np.ascontiguousarray(init), device=device)
    if not torch.equal(c[0], p[first]):
        return 1.0
    p64 = p.double()
    dists = ((p64 - p64[first]) ** 2).sum(1)
    gap = 0.0
    for i, f in enumerate(factors, start=1):
        hit = torch.nonzero((p == c[i]).all(1)).flatten()
        if hit.numel() == 0:
            return 1.0
        cum = torch.cumsum(dists, 0) / dists.sum()
        lo_hi = []
        for j in hit.tolist():
            lo = float(cum[j - 1]) if j else 0.0
            lo_hi.append(max(0.0, lo - f, f - float(cum[j])))
        gap = max(gap, min(lo_hi))
        dists = torch.minimum(dists, ((p64 - c[i].double()) ** 2).sum(1))
    return gap


def _assign_margins(p64, c64, assign):
    """(largest relative margin by which an assignment misses the
    nearest centroid, the distances of the assigned centroids, the
    distances' scale ‖p‖² + ‖c‖²) for one client."""
    d = _sqdist(p64, c64)
    a = torch.as_tensor(assign, device=p64.device).long()
    mine = d.gather(1, a[:, None])[:, 0]
    scale = (p64 * p64).sum(1) + (c64 * c64).sum(1)[a]
    margin = ((mine - d.min(1).values) / scale.clamp_min(1e-30))
    return float(margin.max()) if margin.numel() else 0.0, mine, scale


def _judge_kmeans(feats: Sequence[np.ndarray], km: dict, job_seed: int,
                  k: int, device) -> Dict[str, float]:
    out = dict(kmeans_init_gap=0.0, kmeans_assign_margin=0.0,
               kmeans_update_gap=0.0, kmeans_sqd_gap=0.0)
    for m, f in enumerate(feats):
        out["kmeans_init_gap"] = max(out["kmeans_init_gap"], _init_gap(
            f, km["init"][m], threefry.PRNGKey(job_seed + 17 * m), device))
        p64 = torch.as_tensor(f, device=device).double()
        rms = float(torch.sqrt((p64 * p64).mean())) or 1.0
        cents = km["init"][m]
        chain = [(s[m][0], s[m][1]) for s in km["steps"]]
        fc, fa, fsqd = km["final"][m]
        for t, (nxt, a) in enumerate(chain):
            c64 = torch.as_tensor(cents, device=device).double()
            margin, mine, _ = _assign_margins(p64, c64, a)
            out["kmeans_assign_margin"] = max(out["kmeans_assign_margin"],
                                              margin)
            ai = torch.as_tensor(a, device=device).long()
            sums = torch.zeros_like(c64).index_add_(0, ai, p64)
            counts = torch.bincount(ai, minlength=k).double()
            far = p64[int(torch.argmax(mine))]
            want = torch.where((counts > 0)[:, None],
                               sums / counts.clamp_min(1)[:, None], far[None])
            got = torch.as_tensor(nxt, device=device).double()
            out["kmeans_update_gap"] = max(
                out["kmeans_update_gap"],
                float((got - want).abs().max()) / rms)
            cents = nxt
        last = torch.as_tensor(np.asarray(cents), device=device).double()
        final = torch.as_tensor(fc, device=device).double()
        out["kmeans_update_gap"] = max(out["kmeans_update_gap"], float(
            (final - last).abs().max()) / rms)
        margin, mine, scale = _assign_margins(p64, final, fa)
        out["kmeans_assign_margin"] = max(out["kmeans_assign_margin"],
                                          margin)
        sqd = torch.as_tensor(fsqd, device=device).double()
        out["kmeans_sqd_gap"] = max(out["kmeans_sqd_gap"], float(
            ((sqd - mine).abs() / scale.clamp_min(1e-30)).max()))
    return out


def _change_gap(got: dict, want: dict, init: dict) -> float:
    """The worst leaf's gap of the norms of the parameters' change from
    ``init``, |‖got - init‖ - ‖want - init‖|, over the larger of that
    leaf's reference change and the median leaf's."""
    def change(params):
        return [np.linalg.norm(np.asarray(a, np.float64) - b)
                for a, b in zip(_leaves(params), _leaves(init))]
    g, w = change(got), change(want)
    med = float(np.median(w))
    return float(max(abs(a - b) / max(b, med, 1e-30) for a, b in zip(g, w)))


def _stop_mismatch(got: Sequence[float], want: Sequence[float],
                   mdl: dict) -> int:
    """1 where the program's epoch count breaks the paper's stopping rule
    read on the reference's losses: the rule (the loss changed by less
    than ``convergence_eps`` over ``convergence_window`` epochs) fired
    before the last epoch, or did not fire at it short of
    ``max_epochs``.  A change within twice the largest gap of the two
    sides' losses of ``convergence_eps`` counts either way, since the
    program reads the rule on its own f32 losses."""
    e, cap = len(got), int(mdl["max_epochs"])
    wlen, eps = int(mdl["convergence_window"]), float(mdl["convergence_eps"])
    tol = 2 * max((abs(a - b) for a, b in zip(got, want)), default=0.0)
    delta = [abs(want[i - wlen] - want[i]) for i in range(wlen, e)]
    early = any(d < eps - tol for d in delta[:-1])
    late = e < cap and (not delta or delta[-1] >= eps + tol)
    return int(e == 0 or e > cap or early or late)


def judge_job(rec: dict, parts: Partitions, config: dict, variant: str, *,
              device="cpu") -> Dict[str, float]:
    """The numbers of one job's ``record`` against the reference (the
    module docstring says how each stage is followed):

    - ``align_wrong_ids``: ids in one intersection and not the other;
    - ``kmeans_init_gap``: ``_init_gap``, the worst client;
    - ``kmeans_assign_margin``: the largest margin, relative to
      ‖p‖² + ‖c‖², by which a row of any step or of the final pass
      sits farther from its centroid than from the nearest;
    - ``kmeans_update_gap``: the largest gap between a step's
      centroids and the f64 means of the rows the program assigned (the
      farthest row for an empty cluster), over the data's RMS;
    - ``kmeans_sqd_gap``: the final distances' largest relative gap;
    - ``coreset_mismatch``: rows in one coreset and not the other, plus
      common rows whose weights differ in any bit;
    - ``work_mismatch``: Lloyd steps more or fewer than the
      configuration's ``kmeans_iters``, plus 1 where the epoch count
      breaks the stopping rule (``_stop_mismatch``);
    - ``train_loss_gap``: the largest gap of an epoch's loss, over the
      reference's first;
    - ``train_param_gap``: ``_change_gap`` of the trained parameters
      from the initial ones;
    - ``eval_out_gap``: the largest gap of a raw test output, over
      max(1, the largest reference output)."""
    n = parts.train[0].shape[0]
    sets = job_ids(config, n, rec["job_seed"])
    inter, rows = align(sets)
    got = np.asarray(rec["intersection"])
    out = {"align_wrong_ids": float(np.setxor1d(got, inter).size
                                    + abs(got.size - np.unique(got).size))}
    later = (["kmeans_init_gap", "kmeans_assign_margin", "kmeans_update_gap",
              "kmeans_sqd_gap", "coreset_mismatch"]
             if variant.endswith("css") else []) + [
                 "work_mismatch", "train_loss_gap", "train_param_gap",
                 "eval_out_gap"]
    if out["align_wrong_ids"]:
        # the program's later stages ran on other rows: none can be
        # followed, and each fails
        return dict(out, **{name: math.inf for name in later})
    feats = [f[rows] for f in parts.train]
    labels = parts.train_labels[rows]
    mdl = job_settings(config, rec["job_seed"])
    weights = None
    work = 0
    if variant.endswith("css"):
        k = int(config["coreset"]["clusters_per_client"])
        km = rec["kmeans"]
        work += abs(len(km["steps"]) - int(config["coreset"]["kmeans_iters"]))
        out.update(_judge_kmeans(feats, km, rec["job_seed"], k, device))
        idx, w = select([f[1] for f in km["final"]],
                        [f[2] for f in km["final"]], labels, k)
        g_idx, g_w = (np.asarray(a) for a in rec["coreset"])
        common, ia, ib = np.intersect1d(idx, g_idx, return_indices=True)
        out["coreset_mismatch"] = float(
            np.setxor1d(idx, g_idx).size
            + np.count_nonzero(w[ia].view(np.int32)
                               != g_w[ib].astype(np.float32).view(np.int32)))
        # training follows the program's coreset: rows and weights
        feats = [f[g_idx] for f in feats]
        labels = labels[g_idx]
        weights = g_w if config["coreset"]["use_weights"] else None
    if not rec["losses"]:                       # no epoch was trained
        return dict(out, work_mismatch=1.0, train_loss_gap=math.inf,
                    train_param_gap=math.inf, eval_out_gap=math.inf)
    losses, params = train(mdl, feats, labels, weights,
                           epochs=len(rec["losses"]), device=device)
    first = max(abs(losses[0]), 1e-30)
    out["train_loss_gap"] = max(abs(a - b) for a, b in
                                zip(rec["losses"], losses)) / first
    out["work_mismatch"] = float(work + _stop_mismatch(rec["losses"],
                                                       losses, mdl))
    out["train_param_gap"] = _change_gap(
        rec["params"], params, init_params(mdl, [f.shape[1] for f in feats]))
    want = predict(rec["params"], mdl["model"], parts.test, device=device)
    got_out = np.asarray(rec["eval_out"], np.float64)
    out["eval_out_gap"] = (float(np.abs(got_out - want).max())
                           / max(1.0, float(np.abs(want).max()))
                           if got_out.shape == want.shape else math.inf)
    return out

