/* Realtime-order edge sweep for the elle engines.
 *
 * The reference's realtime relation comes from elle's
 * process/realtime graphs (jepsen/src/jepsen/tests/cycle/append.clj
 * wires elle.core's realtime-graph); the Python engine reduces it
 * with a completion-frontier sweep (gpu/elle.py order_edge_arrays).
 * This is that exact sweep in C: events sorted by (position,
 * completion-before-invocation), a covering frontier of completed
 * txns, an edge from every frontier member to each invoking txn.
 * Indices in/out are dense 0..n-1 positions into the caller's txn
 * arrays.
 *
 * Returns the edge count, -1 if cap was too small (caller retries
 * with a bigger buffer), -2 on allocation failure.
 */

#include <stdint.h>
#include <stdlib.h>

#ifdef __cplusplus
extern "C" {
#endif


typedef struct {
    int64_t pos;
    int32_t is_inv;
    int64_t t;
} jt_event;

static int jt_ev_cmp(const void *a, const void *b) {
    const jt_event *x = (const jt_event *)a;
    const jt_event *y = (const jt_event *)b;
    if (x->pos != y->pos)
        return x->pos < y->pos ? -1 : 1;
    if (x->is_inv != y->is_inv)
        return x->is_inv < y->is_inv ? -1 : 1;
    return x->t < y->t ? -1 : (x->t > y->t ? 1 : 0);
}

int64_t jt_realtime_edges(const int64_t *inv, const int64_t *comp,
                          int64_t n, int64_t *out_src,
                          int64_t *out_dst, int64_t cap) {
    if (n <= 0)
        return 0;
    jt_event *events =
        (jt_event *)malloc(sizeof(jt_event) * 2 * (size_t)n);
    int64_t *frontier =
        (int64_t *)malloc(sizeof(int64_t) * (size_t)n);
    if (!events || !frontier) {
        free(events);
        free(frontier);
        return -2;
    }
    for (int64_t i = 0; i < n; i++) {
        events[2 * i].pos = inv[i];
        events[2 * i].is_inv = 1;
        events[2 * i].t = i;
        events[2 * i + 1].pos = comp[i];
        events[2 * i + 1].is_inv = 0;
        events[2 * i + 1].t = i;
    }
    qsort(events, 2 * (size_t)n, sizeof(jt_event), jt_ev_cmp);
    int64_t fn = 0, m = 0;
    for (int64_t e = 0; e < 2 * n; e++) {
        int64_t t = events[e].t;
        if (events[e].is_inv) {
            /* edge from every covering completed txn */
            for (int64_t j = 0; j < fn; j++) {
                int64_t a = frontier[j];
                if (a == t)
                    continue;
                if (m >= cap) {
                    free(events);
                    free(frontier);
                    return -1;
                }
                out_src[m] = a;
                out_dst[m] = t;
                m++;
            }
        } else {
            /* completion: drop frontier members this txn covers
             * (their completion precedes its invocation) */
            int64_t keep = 0;
            for (int64_t j = 0; j < fn; j++)
                if (comp[frontier[j]] >= inv[t])
                    frontier[keep++] = frontier[j];
            fn = keep;
            frontier[fn++] = t;
        }
    }
    free(events);
    free(frontier);
    return m;
}

#ifdef __cplusplus
}  /* extern "C" */
#endif
