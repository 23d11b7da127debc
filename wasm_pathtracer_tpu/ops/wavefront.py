"""Flattened persistent wavefront: traversal fused into the path loop.

The mesh-scale problem with :func:`ops.integrator.render_queue` is that
every bounce calls ``trace_scene``, whose cluster traversal
(``ops.cluster.trace_clusters``) is itself a *nested* lockstep
``while_loop``: all lanes wait for the slowest ray's probe sequence at
every bounce, then wait again for the slowest NEE shadow ray.  On a
100k-triangle cloud the tail rays need tens of probe rounds, so typical
lane utilization inside the nested loop collapses.

Here the traversal micro-steps become part of the *outer* persistent
loop — the same flattening that path regeneration applies to bounces,
applied one level deeper (the reference's analog is the per-ray early
``return`` inside the recursive descent, ``scene.rs:218-288``).  Each
lane carries a tiny state machine:

  SCAN   start a trace: one dense pass over the non-clustered families
         (``trace_scene`` with the cluster detached — the Pallas scene
         kernel when the prep enables it) plus a rays x cluster-AABB
         slab test whose per-cluster entry distances become the lane's
         carried candidate row;
  PROBE  up to two clusters per iteration, in ascending (entry, id)
         order (ties to the lowest id — the same order as the lockstep
         retire loop): each candidate's (G, 9) block is gathered and
         tested densely with the masked type switch
         (``ops.cluster._block_test``), with the distance bound
         re-tightened between the two rounds; a lane stops when its
         nearest remaining entry exceeds its running best — the
         reference's ``max_dis`` pruning (``scene.rs:262-288``).  Two
         rounds per slab pass because most traces finish within two
         probes, so the (B, C) slab — the widest op in the loop — runs
         ~once per trace;
  SHADE  the estimator step (:func:`ops.integrator._shade_core` — the
         exact code the lockstep drivers run), which may emit a
         deferred NEE shadow query: the lane then traces the shadow
         ray through the same SCAN/PROBE machinery and resolves the
         occlusion on completion;
  REGEN  finished paths splat into the frame accumulator and pull the
         next sample off the pixel queue, exactly as ``render_queue``.

Every outer iteration advances *every* live lane one micro-step, so no
lane ever waits for another's traversal: the probe work per iteration
is one dense (lanes x G) block test at full occupancy.

Because the visit order is ascending ``(entry, id)``, the entire
"already visited" state is a TWO-SCALAR LEX CURSOR per lane:
``(skip_e, skip_c)`` — the last visited (entry, id).  Each iteration
recomputes the slab entries, masks everything lex-<= the cursor, and
takes the lex-min.  Two earlier designs were rejected: a sorted top-k
shortlist (``lax.top_k`` per iteration, plus a rescan protocol to stay
exact) and a carried (lanes, C) entry matrix with argmin-retire (exact,
but it carries a lanes x C matrix through the loop and pays a
(lanes, C) retire write every iteration).

The per-lane block gather+test is plain XLA: a ``jnp.take`` of each
lane's (G, 9) cluster block feeding ``ops.cluster._block_test``.  Frame
accumulation is DEFERRED: finished paths record (pixel, color) into a
lane-local ring buffer via a dense one-hot write, and ONE scatter at
the end of the dispatch folds all records into the frame.  Ring
capacity K = ceil(S/B) + slack; a lane that fills its ring stops
claiming new paths, and since all lanes capped implies B*K >= S paths
issued, no queue slot can ever be stranded.

Exactness: argmin-retire visits clusters in ascending
``(entry_distance, cluster_id)`` order — identical to the lockstep
``trace_clusters`` loop — and per-path radiance is bit-identical to
``render_queue`` (same RNG slots, same estimator code, same
nearest-hit tie-breaking); only the per-pixel float accumulation order
differs.

Shadow rays resolve nearest-hit semantics identical to
``trace.shadow_ray`` (the sampled light shape does not occlude), with
one extra *pruning* bound: clusters entirely beyond the light distance
cannot change the verdict and are skipped, so the probe count (the
cost metric) can undercount the lockstep path's — never the verdict.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from wasm_pathtracer_tpu.config import RenderSettings
from wasm_pathtracer_tpu.models.camera import Camera, primary_rays
from wasm_pathtracer_tpu.ops import cluster as cl
from wasm_pathtracer_tpu.ops import trace as tr
from wasm_pathtracer_tpu.ops import integrator as itg
from wasm_pathtracer_tpu.utils import rng as rnglib
from wasm_pathtracer_tpu.utils import vecmath as vm

# In-loop regen: read claimed queue slots via dynamic-slice + rank
# pick instead of a full-table gather (fewer ops for the same values).
GEN_CONTIG = True


def render_queue_flat(prep: tr.ScenePrep, scene, settings: RenderSettings,
                      camera: Camera, pix_queue, width: int, height: int,
                      seed, n_lanes: int, photon_grid=None, rid_base=0,
                      return_iters: bool = False):
    """Persistent wavefront with flattened cluster traversal.

    Same contract as :func:`ops.integrator.render_queue` (same queue
    semantics, same RNG keying, same return triple) — requires
    ``prep.cluster``; the session picks this form for cluster scenes.

    Returns (color_sum (H*W, 3), n_samples (H*W,) int32, lane_cost
    (n_lanes,) int32).
    """
    assert prep.cluster is not None, "render_queue_flat needs clusters"
    cs = prep.cluster
    S = pix_queue.shape[0]
    B = n_lanes
    G = cs.blocks.shape[1]
    C = cs.blocks.shape[0]
    HW = width * height
    def _early(counts):
        out = (jnp.zeros((HW, 3), jnp.float32), counts,
               jnp.zeros((B,), jnp.int32))
        return out + (jnp.int32(0),) if return_iters else out
    if S == 0:
        return _early(jnp.zeros((HW,), jnp.int32))
    if settings.max_bounces == 0:
        return _early(jnp.zeros((HW,), jnp.int32).at[pix_queue].add(1))

    light_tab = itg._light_table(scene)
    packed_rows = tr.pack_hit_rows(scene)   # loop-invariant
    prep_nc = dataclasses.replace(prep, cluster=None)
    sid_grid = cs.slot_to_sid.reshape(C, G)
    eps = settings.epsilon
    max_b = jnp.uint32(settings.max_bounces)

    # ring capacity: ceil(S/B) guarantees no stranded queue slot (all
    # lanes capped => B*K >= S paths recorded); slack covers imbalance
    K = -(-S // B)
    K += max(2, K // 2)

    def _ray_of(pid, sidx):
        """Primary ray for pixel ``pid`` / queue slot ``sidx``."""
        rid = jnp.uint32(rid_base) + sidx.astype(jnp.uint32)
        px = pid % width
        py = pid // width
        jx, jy, _ = rnglib.uniform3(seed, rid, itg.SLOT_JITTER)
        o, d = primary_rays(camera, px, py, jx, jy, width, height,
                            settings.screen_z)
        return pid, rid, o, d

    def gen(sidx):
        """Primary ray for queue slot ``sidx`` (clamped; masked later)."""
        return _ray_of(pix_queue[jnp.clip(sidx, 0, S - 1)], sidx)

    # in-loop regen reads the queue WITHOUT a big gather: claimed slots
    # are the contiguous range [issued, issued + n), so one dynamic
    # slice pulls the next B queue entries and a rank-indexed pick from
    # that B-sized block distributes them.  Padding rows carry the HW
    # drop sentinel and are never claimed (can requires new_sidx < S).
    pixq_pad = jnp.concatenate(
        [pix_queue, jnp.full((B,), HW, jnp.int32)])

    def gen_contig(issued, ranks):
        block = jax.lax.dynamic_slice(
            pixq_pad, (jnp.clip(issued, 0, S),), (B,))
        pid = jnp.minimum(block[jnp.clip(ranks, 0, B - 1)], HW)
        return _ray_of(pid, issued + ranks)

    sidx0 = jnp.arange(B, dtype=jnp.int32)
    pid0, rid0, o0, d0 = gen(sidx0)
    f3 = lambda: jnp.zeros((B, 3), jnp.float32)
    state = dict(
        issued=jnp.int32(min(B, S)),
        # --- path registers -------------------------------------------
        o=o0, d=d0,                      # next-bounce ray (set at shade)
        tp=jnp.ones((B, 3), jnp.float32),
        col=f3(),
        hdb=jnp.zeros((B,), bool),
        absorb=f3(),
        bounce=jnp.zeros((B,), jnp.uint32),
        pid=pid0, rid=rid0,
        live=sidx0 < S,
        # --- trace registers ------------------------------------------
        tr_o=o0, tr_d=d0,                # the ray being traced
        shadow=jnp.zeros((B,), bool),    # tracing a shadow query?
        t_best=jnp.full((B,), jnp.inf, jnp.float32),
        sid_best=jnp.full((B,), -1, jnp.int32),
        # lex cursor over the ascending (entry, id) visit order: the
        # last probed (entry, id); fresh traces reset to (-inf, -1)
        skip_e=jnp.full((B,), -jnp.inf, jnp.float32),
        skip_c=jnp.full((B,), -1, jnp.int32),
        need_scan=sidx0 < S,
        # --- pending NEE query (set at shade, used at resolve) --------
        pend_contrib=f3(),
        pend_dist=jnp.zeros((B,), jnp.float32),
        pend_lsid=jnp.zeros((B,), jnp.int32),
        pend_cont=jnp.zeros((B,), bool),  # path survives past this bounce
        # --- deferred frame records (scattered once, at the end) ------
        ring_col=jnp.zeros((K, B, 3), jnp.float32),
        ring_pid=jnp.full((K, B), HW, jnp.int32),    # HW = drop sentinel
        k_lane=jnp.zeros((B,), jnp.int32),
        cost=jnp.zeros((B,), jnp.int32),
        iters=jnp.int32(0),   # loop-iteration diagnostic (scalar +1)
    )

    def cond(st):
        return jnp.any(st["live"])

    def body(st):
        live = st["live"]
        tr_o, tr_d = st["tr_o"], st["tr_d"]
        shadow = st["shadow"]

        # ---- SCAN: dense trace for freshly started traces --------------
        scan = live & st["need_scan"]
        skip_e = jnp.where(scan, -jnp.inf, st["skip_e"])
        skip_c = jnp.where(scan, -1, st["skip_c"])
        with jax.named_scope("flat_scan"):
            t_d, sid_d, _, c_d = tr.trace_scene(prep_nc, scene, tr_o, tr_d)
        t_best = jnp.where(scan, t_d, st["t_best"])
        sid_best = jnp.where(scan, sid_d, st["sid_best"])
        cost = st["cost"] + jnp.where(scan, c_d, 0)

        # ---- PROBE x2: the two lex-min unvisited clusters per lane -----
        # entries are recomputed every iteration; "visited" is the lex
        # cursor (skip_e, skip_c) since the visit order is ascending.
        # One slab pass yields TWO candidates (plus the entry after
        # both), and both get probed this iteration — most traces need
        # <= 2 probe rounds, so the (B, C) slab cost runs ~once per
        # trace instead of once per probe
        def _lexmin(ent):
            # lex tie-break: among minimal entries, the lowest id
            e = jnp.min(ent, axis=1)
            c = jnp.minimum(
                jnp.min(jnp.where(ent == e[:, None], cid, C), axis=1),
                C - 1)
            rest = jnp.where((ent > e[:, None]) |
                             ((ent == e[:, None]) & (cid > c[:, None])),
                             ent, jnp.inf)
            return e, c, rest

        with jax.named_scope("flat_select"):
            ent = cl._rays_vs_boxes(tr_o, tr_d, cs.lo, cs.hi)  # (B, C)
            cid = jax.lax.broadcasted_iota(jnp.int32, ent.shape, 1)
            unvisited = (ent > skip_e[:, None]) | \
                ((ent == skip_e[:, None]) & (cid > skip_c[:, None]))
            ent = jnp.where(unvisited, ent, jnp.inf)
            e_cur, c_cur, ent1 = _lexmin(ent)
            e_b, c_b, ent2 = _lexmin(ent1)
            e_aft = jnp.min(ent2, axis=1)

        @jax.named_scope("flat_probe")
        def _probe(c_sel, probing, t_best, sid_best, cost):
            block = jnp.take(cs.blocks, c_sel, axis=0)      # (B, G, 9)
            btype = jnp.take(cs.btype, c_sel, axis=0)       # (B, G)
            t_blk = cl._block_test(tr_o, tr_d, block, btype, cs.families)
            jloc = jnp.argmin(t_blk, axis=1).astype(jnp.int32)
            tloc = jnp.min(t_blk, axis=1)
            sid_loc = jnp.take(sid_grid, c_sel, axis=0)[
                jnp.arange(B), jloc]                        # (B,)
            better = probing & (tloc < t_best)
            t_best = jnp.where(better, tloc, t_best)
            sid_best = jnp.where(better, sid_loc, sid_best)
            cost = cost + jnp.where(probing, G, 0)
            return t_best, sid_best, cost

        bound = jnp.where(shadow, jnp.minimum(t_best, st["pend_dist"]),
                          t_best)
        probing = live & (e_cur < bound)
        skip_e = jnp.where(probing, e_cur, skip_e)
        skip_c = jnp.where(probing, c_cur, skip_c)
        t_best, sid_best, cost = _probe(c_cur, probing, t_best, sid_best,
                                        cost)

        # second round against the bound tightened by the first —
        # exactly the lockstep retire loop's pruning sequence
        bound = jnp.where(shadow, jnp.minimum(t_best, st["pend_dist"]),
                          t_best)
        probing2 = probing & (e_b < bound)
        skip_e = jnp.where(probing2, e_b, skip_e)
        skip_c = jnp.where(probing2, c_b, skip_c)
        t_best, sid_best, cost = _probe(c_b, probing2, t_best, sid_best,
                                        cost)

        # ---- completion ------------------------------------------------
        # next candidate strictly after the (possibly advanced) cursor
        e_next = jnp.where(probing2, e_aft,
                           jnp.where(probing, e_b, e_cur))
        bound = jnp.where(shadow, jnp.minimum(t_best, st["pend_dist"]),
                          t_best)
        # shadow queries EARLY-ACCEPT: the verdict "occluded" is
        # monotone — any non-light hit closer than the light proves it
        # regardless of still-closer hits, so the query need not prove
        # the closest hit like a primary trace (same predicate the
        # resolve step tests; radiance is bit-identical, only the
        # probe-count cost metric can undercount further — the same
        # contract as the beyond-light pruning documented above)
        early_occ = shadow & jnp.isfinite(t_best) & \
            (t_best < st["pend_dist"]) & (sid_best != st["pend_lsid"])
        done = live & ((e_next >= bound) | early_occ)

        # ---- RESOLVE: finished shadow queries --------------------------
        resolve = done & shadow
        occluded = jnp.isfinite(t_best) & (t_best < st["pend_dist"]) \
            & (sid_best != st["pend_lsid"])
        col = st["col"] + jnp.where((resolve & ~occluded)[:, None],
                                    st["pend_contrib"], 0.0)

        # ---- SHADE: finished primary traces ----------------------------
        shade = done & ~shadow
        slot0 = st["bounce"] * itg._SLOTS_PER_BOUNCE
        (o_n, d_n, tp_n, col_n, alive_n, hdb_n, absorb_n), req = \
            itg._shade_core(prep, scene, settings, light_tab, photon_grid,
                            tr_o, tr_d, st["tp"], col, shade, st["hdb"],
                            st["absorb"], slot0, st["rid"], seed,
                            t_best, sid_best, jnp.isfinite(t_best),
                            packed_rows=packed_rows)
        # adopt estimator updates ONLY on shade lanes: _shade_core's
        # carry passes (tr_o, tr_d) — the ray currently being traced —
        # through unchanged on non-scatter lanes, so adopting o_n/d_n
        # unmasked would overwrite a lane's stored next-bounce BSDF ray
        # with its in-flight shadow ray (and its Beer-Lambert throughput
        # multiply is unmasked, so tp_n is also only valid on shade)
        sh3 = shade[:, None]
        o = jnp.where(sh3, o_n, st["o"])
        d = jnp.where(sh3, d_n, st["d"])
        tp = jnp.where(sh3, tp_n, st["tp"])
        absorb = jnp.where(sh3, absorb_n, st["absorb"])
        hdb = jnp.where(shade, hdb_n, st["hdb"])
        # col_n's adds are all gated on alive(=shade) so it is exact for
        # every lane, including this iteration's resolve adds
        col = col_n
        bounce = jnp.where(shade, st["bounce"] + jnp.uint32(1), st["bounce"])
        cont_shade = alive_n & (bounce < max_b)

        if req is not None:
            pend = shade & req["need"]
            to_l = req["p_to"] - req["p_from"]
            dir_len = vm.length(to_l)
            d_sh = to_l / jnp.maximum(dir_len, 1e-30)[..., None]
            o_sh = req["p_from"] + d_sh * eps
            pend_contrib = jnp.where(pend[:, None], req["contrib"],
                                     st["pend_contrib"])
            pend_dist = jnp.where(pend, dir_len, st["pend_dist"])
            pend_lsid = jnp.where(pend, req["light_sid"], st["pend_lsid"])
        else:
            pend = jnp.zeros((B,), bool)
            o_sh = tr_o
            d_sh = tr_d
            pend_contrib = st["pend_contrib"]
            pend_dist = st["pend_dist"]
            pend_lsid = st["pend_lsid"]
        pend_cont = jnp.where(shade, cont_shade, st["pend_cont"])

        # ---- FINALIZE: bounce complete (shadow resolved or not needed) -
        fin = resolve | (shade & ~pend)
        cont = fin & jnp.where(shadow, st["pend_cont"], cont_shade)
        end = fin & ~cont

        # record finished paths into the lane ring (dense one-hot write;
        # the single frame scatter happens after the loop) and regen
        # from the queue in lane-order ranks (deterministic)
        sel = (jax.lax.broadcasted_iota(jnp.int32, (K, B), 0)
               == st["k_lane"][None, :]) & end[None, :]
        ring_col = jnp.where(sel[..., None], col[None], st["ring_col"])
        ring_pid = jnp.where(sel, st["pid"][None], st["ring_pid"])
        k_lane = st["k_lane"] + end.astype(jnp.int32)

        claimable = end & (k_lane < K)   # ring slot left for a new path
        ranks = jnp.cumsum(claimable.astype(jnp.int32)) - 1
        new_sidx = st["issued"] + ranks
        can = claimable & (new_sidx < S)
        issued = jnp.minimum(
            st["issued"] + jnp.sum(claimable.astype(jnp.int32)), S)
        pid_n, rid_n, o_p, d_p = (gen_contig(st["issued"], ranks)
                                  if GEN_CONTIG else gen(new_sidx))
        canc = can[:, None]

        # next traced ray: shadow query > regenerated primary > next bounce
        tr_o2 = jnp.where(pend[:, None], o_sh,
                          jnp.where(canc, o_p,
                                    jnp.where(cont[:, None], o, tr_o)))
        tr_d2 = jnp.where(pend[:, None], d_sh,
                          jnp.where(canc, d_p,
                                    jnp.where(cont[:, None], d, tr_d)))
        start = pend | can | cont

        return dict(
            issued=issued,
            o=jnp.where(canc, o_p, o),
            d=jnp.where(canc, d_p, d),
            tp=jnp.where(canc, 1.0, tp),
            col=jnp.where(canc, 0.0, col),
            hdb=jnp.where(can, False, hdb),
            absorb=jnp.where(canc, 0.0, absorb),
            bounce=jnp.where(can, jnp.uint32(0), bounce),
            pid=jnp.where(can, pid_n, st["pid"]),
            rid=jnp.where(can, rid_n, st["rid"]),
            live=(live & ~end) | can,
            tr_o=tr_o2, tr_d=tr_d2,
            shadow=jnp.where(start, pend, shadow),
            t_best=t_best, sid_best=sid_best,
            skip_e=skip_e, skip_c=skip_c,
            need_scan=jnp.where(start, True, jnp.zeros((B,), bool)),
            pend_contrib=pend_contrib,
            pend_dist=pend_dist,
            pend_lsid=pend_lsid,
            pend_cont=pend_cont,
            ring_col=ring_col, ring_pid=ring_pid, k_lane=k_lane,
            cost=cost,
            iters=st["iters"] + 1,
        )

    st = jax.lax.while_loop(cond, body, state)
    # the ONE frame scatter: unwritten ring slots carry the HW sentinel
    # and drop; sharded callers' queue-pad paths carry pid >= HW and
    # drop the same way
    rp = st["ring_pid"].reshape(-1)
    accum = jnp.zeros((HW, 3), jnp.float32).at[rp].add(
        st["ring_col"].reshape(-1, 3), mode="drop")
    counts = jnp.zeros((HW,), jnp.int32).at[rp].add(1, mode="drop")
    if return_iters:
        return accum, counts, st["cost"], st["iters"]
    return accum, counts, st["cost"]
