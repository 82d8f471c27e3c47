/* Emu Chick tick kernel — C transliteration of emu.simulate_reference.
 *
 * Compiled on demand by repro_torch/core/_emu_cext.py (cc -O3 -shared -fPIC
 * -ffp-contract=off) and loaded through ctypes.  Semantics must stay
 * tick-for-tick identical to the Python reference engine:
 * tests/test_torch_emu.py pins ticks, migrations, per-nodelet
 * instruction counts and residency traces across all engines.
 *
 * -ffp-contract=off matters: the congestion / efficiency factors are IEEE
 * double expressions evaluated in the same order as numpy evaluates them;
 * a fused multiply-add would round differently and can flip the truncated
 * integer budgets by one cycle.
 *
 * The function runs ticks until the simulation finishes, max_ticks is hit,
 * or the residency sample buffer is full.  In the latter case it returns 1
 * with all state written back, and the caller grows the buffer and calls
 * again (the capacity check happens before a sampling tick mutates any
 * state, so re-entry is seamless).
 */
#include <stdint.h>

typedef int64_t i64;

enum { ST_RUNNING = 0, ST_WANT = 1, ST_QUEUED = 2, ST_FLIGHT = 3,
       ST_DONE = 4 };

i64 emu_run_ticks(
    /* machine configuration */
    i64 nthreads, i64 P, i64 tpn, i64 tick_cycles, i64 qcap,
    i64 me_rate, i64 ingress_rate, i64 resident_cap, i64 latency,
    i64 mig_cycles, i64 latency_hide, double cong_floor,
    i64 max_ticks, i64 sample_every,
    /* flattened segment traces (read-only) */
    const i64 *flat_nodes, const i64 *flat_cost, const i64 *seg_end,
    /* per-thread state */
    i64 *loc, int8_t *state, i64 *ptr, i64 *rem, i64 *dest, i64 *arrive,
    /* per-nodelet state: egress is (P, qcap) row-major FIFO */
    i64 *egress, i64 *qlen, i64 *instr,
    /* scratch (sizes: nthreads, P, P+1, nthreads, nthreads, P, P, P) */
    i64 *run_buf, i64 *run_cnt, i64 *run_off, i64 *cur, i64 *alive,
    i64 *residents, i64 *credits, double *cong,
    /* residency trace: (res_cap, P) int32, res_len rows used */
    int32_t *res_buf, i64 res_cap, i64 *res_len,
    /* loop registers (in/out) */
    i64 *tick_io, i64 *rr_io, i64 *migrations_io, i64 *n_done_io)
{
    i64 tick = *tick_io, rr = *rr_io, migrations = *migrations_io,
        n_done = *n_done_io, rlen = *res_len;
    i64 p, t, j;

    while (tick < max_ticks && n_done < nthreads) {
        int will_sample = (tick % sample_every) == 0;
        if (will_sample && rlen >= res_cap)
            break;                      /* pause: caller grows the buffer */

        /* Congestion factor per nodelet from egress-queue occupancy. */
        for (p = 0; p < P; p++)
            cong[p] = 1.0 - (1.0 - cong_floor) *
                ((double)qlen[p] / (double)qcap);

        /* --- 1. execute on each nodelet --------------------------------
         * Bucket RUNNING threads by nodelet in ascending id order. */
        for (p = 0; p < P; p++) run_cnt[p] = 0;
        for (t = 0; t < nthreads; t++)
            if (state[t] == ST_RUNNING) run_cnt[loc[t]]++;
        run_off[0] = 0;
        for (p = 0; p < P; p++) run_off[p + 1] = run_off[p] + run_cnt[p];
        for (p = 0; p < P; p++) residents[p] = run_off[p]; /* fill cursor */
        for (t = 0; t < nthreads; t++)
            if (state[t] == ST_RUNNING) run_buf[residents[loc[t]]++] = t;

        for (p = 0; p < P; p++) {
            i64 n = run_cnt[p];
            const i64 *base;
            i64 cap, ncur, shift, budget;
            double eff;
            if (n == 0) continue;
            /* Throttle thread activity as the migration queue fills. */
            cap = (i64)((double)tpn *
                        (1.0 - (double)qlen[p] / (double)qcap));
            if (cap < 2) cap = 2;
            /* np.roll(running, -rr)[:cap] */
            ncur = cap < n ? cap : n;
            base = run_buf + run_off[p];
            shift = rr % n;
            for (j = 0; j < ncur; j++)
                cur[j] = base[(j + shift) % n];
            /* Issue bandwidth degrades when too few threads hide latency,
             * and when the migration queue steals DRAM bandwidth. */
            eff = (double)ncur / (double)latency_hide;
            if (eff > 1.0) eff = 1.0;
            eff = eff * cong[p];
            budget = (i64)((double)tick_cycles * eff);
            /* Fair-share passes: threads cycle until budget or work runs
             * out.  Identical to the reference's inner while loop. */
            while (budget > 0 && ncur > 0) {
                i64 share = budget / ncur;
                i64 nalive = 0;
                if (share < 1) share = 1;
                for (j = 0; j < ncur; j++) {
                    i64 take, th;
                    if (budget <= 0) break;
                    th = cur[j];
                    take = share;
                    if (rem[th] < take) take = rem[th];
                    if (budget < take) take = budget;
                    rem[th] -= take;
                    budget -= take;
                    instr[p] += take;
                    if (rem[th] == 0) {
                        /* advance(): thread finished its segment */
                        ptr[th] += 1;
                        if (ptr[th] >= seg_end[th]) {
                            state[th] = ST_DONE;
                            n_done++;
                        } else {
                            i64 nxt = flat_nodes[ptr[th]];
                            rem[th] = flat_cost[ptr[th]];
                            if (nxt != loc[th]) {
                                state[th] = ST_WANT;
                                dest[th] = nxt;
                            }
                        }
                    }
                    if (state[th] == ST_RUNNING && loc[th] == p)
                        alive[nalive++] = th;
                }
                for (j = 0; j < nalive; j++) cur[j] = alive[j];
                ncur = nalive;
            }
        }
        rr += 1;

        /* --- 2. migration requests -> egress queues -------------------- */
        for (t = 0; t < nthreads; t++) {
            if (state[t] != ST_WANT) continue;
            p = loc[t];
            if (qlen[p] < qcap) {
                egress[p * qcap + qlen[p]] = t;
                qlen[p] += 1;
                state[t] = ST_QUEUED;
            }
        }

        /* --- 3. Migration Engine service with destination backpressure - */
        for (p = 0; p < P; p++) residents[p] = 0;
        for (t = 0; t < nthreads; t++)
            if (state[t] != ST_FLIGHT && state[t] != ST_DONE)
                residents[loc[t]]++;
        for (p = 0; p < P; p++) {
            i64 c = resident_cap - residents[p];
            if (c > ingress_rate) c = ingress_rate;
            if (c < 1) c = 1;           /* trickle-accept floor */
            credits[p] = c;
        }
        for (p = 0; p < P; p++) {
            i64 *q = egress + p * qcap;
            i64 n = qlen[p];
            i64 rate, sent = 0, kept = 0;
            if (n == 0) continue;
            rate = (i64)((double)me_rate * cong[p]);
            if (rate < 1) rate = 1;
            for (j = 0; j < n; j++) {
                i64 th = q[j];
                i64 d = dest[th];
                if (sent < rate && credits[d] > 0) {
                    credits[d] -= 1;
                    sent += 1;
                    state[th] = ST_FLIGHT;
                    arrive[th] = tick + latency;
                    migrations += 1;
                    instr[p] += mig_cycles;
                } else {
                    q[kept++] = th;
                }
            }
            qlen[p] = kept;
        }

        /* --- 4. arrivals ----------------------------------------------- */
        for (t = 0; t < nthreads; t++)
            if (state[t] == ST_FLIGHT && arrive[t] <= tick) {
                loc[t] = dest[t];
                dest[t] = -1;
                state[t] = ST_RUNNING;
            }

        /* --- residency sample ------------------------------------------ */
        if (will_sample) {
            int32_t *row = res_buf + rlen * P;
            for (p = 0; p < P; p++) row[p] = 0;
            for (t = 0; t < nthreads; t++)
                if (state[t] != ST_FLIGHT && state[t] != ST_DONE)
                    row[loc[t]] += 1;
            rlen += 1;
        }
        tick += 1;
    }

    *tick_io = tick;
    *rr_io = rr;
    *migrations_io = migrations;
    *n_done_io = n_done;
    *res_len = rlen;
    return (tick < max_ticks && n_done < nthreads) ? 1 : 0;
}
