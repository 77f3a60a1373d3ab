/* A plain partial-order alignment (POA) of a pack of reads into a multiple
 * sequence alignment, as RATTLE's correct step asks spoa for it
 * (correct.cpp:395-405): each read in turn aligned locally (Smith-Waterman,
 * affine gaps: match 5, mismatch -4, gap open -8, gap extend -6) against the
 * graph of the reads before it, threaded into the graph, and one MSA row a
 * read with one column an aligned group.
 *
 * The choices that make the alignment of a read one of its co-optimal ones
 * are the port's documented POA semantics:
 *   - the best cell is the first maximum in (rank, read position) order;
 *   - in the H state the traceback prefers the diagonal (predecessors in
 *     edge insertion order), then F (a gap in the read), then E (a gap in
 *     the graph); ``tiebreak_ef`` swaps the last two (the control);
 *   - E and F keep a gap run going while an extension explains the score;
 *   - the groups keep an order of their own: a run of new groups is placed
 *     right before the next group the read's path meets, a run with no such
 *     group at the end; a group's members follow its leader in the order
 *     they joined.
 *
 * Scalar C, one thread a call; the caller runs packs on threads of its own.
 *
 *     cc -O2 -shared -fPIC -o poa_ref.so poa_ref.c
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

enum { MATCH = 5, MISMATCH = -4, GAP_OPEN = -8, GAP_EXTEND = -6 };
/* the scores of a read of up to MAX_LEN bases fit an int16 cell */
enum { MAX_LEN = 5000 };
#define NEG16 INT16_MIN
#define NEG (-(1 << 29))

typedef struct {
    int *v;
    int n, cap;
} ivec;

static int push(ivec *a, int x) {
    if (a->n == a->cap) {
        int cap = a->cap ? 2 * a->cap : 4;
        int *v = realloc(a->v, (size_t)cap * sizeof(int));
        if (!v) return -1;
        a->v = v;
        a->cap = cap;
    }
    a->v[a->n++] = x;
    return 0;
}

typedef struct {
    int n, cap;
    char *letter;
    ivec *pred;     /* predecessors, in edge insertion order */
    ivec *aligned;  /* the other members of the node's group, as they joined */
    int *leader;    /* the group's first node */
    int *next, *prev; /* the group order, a list over leaders */
    int head, tail;
} graph;

static void graph_free(graph *g) {
    for (int i = 0; i < g->n; i++) {
        free(g->pred[i].v);
        free(g->aligned[i].v);
    }
    free(g->letter);
    free(g->pred);
    free(g->aligned);
    free(g->leader);
    free(g->next);
    free(g->prev);
}

static int add_node(graph *g, char c) {
    if (g->n == g->cap) {
        int cap = g->cap ? 2 * g->cap : 1024;
        char *letter = realloc(g->letter, (size_t)cap);
        if (letter) g->letter = letter;
        ivec *pred = realloc(g->pred, (size_t)cap * sizeof(ivec));
        if (pred) g->pred = pred;
        ivec *aligned = realloc(g->aligned, (size_t)cap * sizeof(ivec));
        if (aligned) g->aligned = aligned;
        int *leader = realloc(g->leader, (size_t)cap * sizeof(int));
        if (leader) g->leader = leader;
        int *next = realloc(g->next, (size_t)cap * sizeof(int));
        if (next) g->next = next;
        int *prev = realloc(g->prev, (size_t)cap * sizeof(int));
        if (prev) g->prev = prev;
        if (!letter || !pred || !aligned || !leader || !next || !prev)
            return -1;
        g->cap = cap;
    }
    int id = g->n++;
    g->letter[id] = c;
    memset(&g->pred[id], 0, sizeof(ivec));
    memset(&g->aligned[id], 0, sizeof(ivec));
    g->leader[id] = id;
    g->next[id] = g->prev[id] = -1;
    return id;
}

static int add_edge(graph *g, int a, int b) {
    ivec *p = &g->pred[b];
    for (int i = 0; i < p->n; i++)
        if (p->v[i] == a) return 0;
    return push(p, a);
}

/* the group order: leaders ``run`` (linked in their order) before ``at``,
 * or at the end where ``at`` is -1 */
static void place_run(graph *g, const int *run, int k, int at) {
    for (int i = 0; i < k; i++) {
        int x = run[i];
        int before = at < 0 ? -1 : g->prev[at];
        if (at < 0) before = g->tail;
        g->prev[x] = before;
        g->next[x] = at;
        if (before >= 0) g->next[before] = x; else g->head = x;
        if (at >= 0) g->prev[at] = x; else g->tail = x;
    }
}

/* nodes in rank order: each group's leader, then its members as they
 * joined */
static void rank_order(const graph *g, int *nodes) {
    int r = 0;
    for (int x = g->head; x >= 0; x = g->next[x]) {
        nodes[r++] = x;
        for (int i = 0; i < g->aligned[x].n; i++) nodes[r++] = g->aligned[x].v[i];
    }
}

static inline int max2(int a, int b) { return a > b ? a : b; }

/* the DP's rows, grown by half again whenever an alignment needs more and
 * reused by the pack's later reads */
typedef struct {
    int16_t *H, *E, *F;
    size_t cells;
} dp_rows;

static int dp_reserve(dp_rows *d, size_t cells) {
    if (cells <= d->cells) return 0;
    cells += cells / 2;
    free(d->H); free(d->E); free(d->F);
    d->H = malloc(cells * sizeof(int16_t));
    d->E = malloc(cells * sizeof(int16_t));
    d->F = malloc(cells * sizeof(int16_t));
    d->cells = (d->H && d->E && d->F) ? cells : 0;
    return d->cells ? 0 : -1;
}

/* Local alignment of s[0..L) against the graph: pairs (node or -1, read
 * position or -1) into an[], ap[] (room for n + L), their count returned in
 * *out_n; every read position appears, the unaligned ends as (-1, j).
 * Returns 0, or -1 where memory ran out. */
static int align(const graph *g, const char *s, int L, int tiebreak_ef,
                 dp_rows *dp, int *an, int *ap, int *out_n) {
    int n = g->n, k = 0;
    if (n == 0) {
        for (int j = 0; j < L; j++) { an[k] = -1; ap[k] = j; k++; }
        *out_n = k;
        return 0;
    }
    size_t W = (size_t)L + 1;
    int *nodes = malloc((size_t)n * sizeof(int));
    int *row_of = malloc((size_t)n * sizeof(int));
    int *pstart = malloc(((size_t)n + 1) * sizeof(int));
    int *diag = malloc(W * sizeof(int));
    int *fv = malloc(W * sizeof(int));
    int *prows = NULL;
    int *tn = NULL, *tp = NULL;
    int rc = -1;
    if (!nodes || !row_of || !pstart || !diag || !fv
            || dp_reserve(dp, (size_t)(n + 1) * W))
        goto done;
    int16_t *H = dp->H, *E = dp->E, *F = dp->F;
    rank_order(g, nodes);
    for (int r = 0; r < n; r++) row_of[nodes[r]] = r + 1;
    /* predecessor rows of each rank, the virtual start row 0 where none */
    size_t np = 0;
    for (int r = 0; r < n; r++) np += g->pred[nodes[r]].n ? g->pred[nodes[r]].n : 1;
    prows = malloc(np * sizeof(int));
    if (!prows) goto done;
    np = 0;
    for (int r = 0; r < n; r++) {
        const ivec *p = &g->pred[nodes[r]];
        pstart[r] = (int)np;
        if (!p->n) prows[np++] = 0;
        for (int i = 0; i < p->n; i++) prows[np++] = row_of[p->v[i]];
    }
    pstart[n] = (int)np;

    for (size_t j = 0; j < W; j++) { H[j] = 0; E[j] = NEG16; F[j] = NEG16; }
    int best = 0, br = 0, bj = 0;
    for (int r = 1; r <= n; r++) {
        char c = g->letter[nodes[r - 1]];
        int16_t *Hr = H + r * W, *Er = E + r * W, *Fr = F + r * W;
        int q0 = pstart[r - 1], q1 = pstart[r];
        const int16_t *Hp = H + (size_t)prows[q0] * W;
        const int16_t *Fp = F + (size_t)prows[q0] * W;
        if (q1 - q0 > 1) {
            /* the best diagonal and F over every predecessor, then the row
             * as from a lone predecessor whose H and F rows are those */
            for (int j = 1; j <= L; j++) {
                diag[j] = Hp[j - 1] + (s[j - 1] == c ? MATCH : MISMATCH);
                fv[j] = max2(Hp[j] + GAP_OPEN, Fp[j] + GAP_EXTEND);
            }
            for (int q = q0 + 1; q < q1; q++) {
                const int16_t *Hq = H + (size_t)prows[q] * W;
                const int16_t *Fq = F + (size_t)prows[q] * W;
                for (int j = 1; j <= L; j++) {
                    int d = Hq[j - 1] + (s[j - 1] == c ? MATCH : MISMATCH);
                    diag[j] = max2(diag[j], d);
                    fv[j] = max2(fv[j], max2(Hq[j] + GAP_OPEN,
                                             Fq[j] + GAP_EXTEND));
                }
            }
        }
        Hr[0] = 0; Er[0] = NEG16; Fr[0] = NEG16;
        int a_prev = 0, e = NEG, many = q1 - q0 > 1;
        for (int j = 1; j <= L; j++) {
            int d, f;
            if (many) {
                d = diag[j];
                f = fv[j];
            } else {
                d = Hp[j - 1] + (s[j - 1] == c ? MATCH : MISMATCH);
                f = max2(Hp[j] + GAP_OPEN, Fp[j] + GAP_EXTEND);
            }
            /* E[j] = max(A[j-1] + open, E[j-1] + extend), A = max(0, diag, F) */
            e = max2(a_prev + GAP_OPEN, e + GAP_EXTEND);
            int a = max2(0, max2(d, f));
            int h = max2(a, e);
            Hr[j] = (int16_t)h; Er[j] = (int16_t)e; Fr[j] = (int16_t)f;
            if (h > best) { best = h; br = r; bj = j; }
            a_prev = a;
        }
    }

    /* the traceback, from the end of the alignment backwards */
    tn = malloc(((size_t)n + L) * sizeof(int));
    tp = malloc(((size_t)n + L) * sizeof(int));
    if (!tn || !tp) goto done;
    int t = 0;
    if (best > 0) {
        int r = br, j = bj;
        char state = 'H';
        for (;;) {
            int h = H[r * W + j];
            if (state == 'H') {
                if (r == 0 || h == 0) break;
                int nid = nodes[r - 1];
                int sub = (j > 0 && s[j - 1] == g->letter[nid]) ? MATCH : MISMATCH;
                int moved = 0;
                if (j > 0) {
                    for (int q = pstart[r - 1]; q < pstart[r]; q++) {
                        if (h == H[prows[q] * W + j - 1] + sub) {
                            tn[t] = nid; tp[t] = j - 1; t++;
                            r = prows[q]; j--; moved = 1;
                            break;
                        }
                    }
                }
                if (moved) continue;
                int f = h == F[r * W + j], e = h == E[r * W + j];
                if (tiebreak_ef ? e : f) state = tiebreak_ef ? 'E' : 'F';
                else if (tiebreak_ef ? f : e) state = tiebreak_ef ? 'F' : 'E';
                else goto done;
            } else if (state == 'E') {
                int ev = E[r * W + j];
                tn[t] = -1; tp[t] = j - 1; t++;
                if (ev != E[r * W + j - 1] + GAP_EXTEND
                        && ev == H[r * W + j - 1] + GAP_OPEN)
                    state = 'H';
                j--;
            } else {
                int fv_ = F[r * W + j], moved = 0;
                tn[t] = nodes[r - 1]; tp[t] = -1; t++;
                for (int q = pstart[r - 1]; q < pstart[r]; q++) {
                    int p = prows[q];
                    if (fv_ == F[p * W + j] + GAP_EXTEND) { r = p; moved = 1; break; }
                    if (fv_ == H[p * W + j] + GAP_OPEN) { r = p; state = 'H'; moved = 1; break; }
                }
                if (!moved) goto done;
            }
        }
    }
    /* the unaligned ends as (-1, j), around the aligned part */
    int first = L, last = -1;
    for (int i = 0; i < t; i++) {
        if (tp[i] < 0) continue;
        if (tp[i] < first) first = tp[i];
        if (tp[i] > last) last = tp[i];
    }
    if (t == 0 || last < 0) { first = 0; last = -1; }
    for (int j = 0; j < first; j++) { an[k] = -1; ap[k] = j; k++; }
    for (int i = t - 1; i >= 0; i--) { an[k] = tn[i]; ap[k] = tp[i]; k++; }
    for (int j = last + 1; j < L; j++) { an[k] = -1; ap[k] = j; k++; }
    *out_n = k;
    rc = 0;
done:
    free(nodes); free(row_of); free(pstart); free(diag); free(fv);
    free(prows); free(tn); free(tp);
    return rc;
}

/* Thread the read along the alignment; its path into path[] (room for L).
 * Returns the path's length, or -1 where memory ran out. */
static int add_alignment(graph *g, const char *s, const int *an,
                         const int *ap, int k, int *path, int *run) {
    int prev = -1, m = 0, nrun = 0;
    for (int i = 0; i < k; i++) {
        if (ap[i] < 0) continue;
        char c = s[ap[i]];
        int target = -1, fresh = 0, nid = an[i];
        if (nid < 0) {
            if ((target = add_node(g, c)) < 0) return -1;
            fresh = 1;
        } else if (g->letter[nid] == c) {
            target = nid;
        } else {
            for (int q = 0; q < g->aligned[nid].n; q++)
                if (g->letter[g->aligned[nid].v[q]] == c) {
                    target = g->aligned[nid].v[q];
                    break;
                }
            if (target < 0) {
                if ((target = add_node(g, c)) < 0) return -1;
                /* the new node joins nid's group */
                ivec *al = &g->aligned[nid];
                if (push(&g->aligned[target], nid)) return -1;
                for (int q = 0; q < al->n; q++)
                    if (push(&g->aligned[target], al->v[q])) return -1;
                int members = g->aligned[target].n;
                for (int q = 0; q < members; q++)
                    if (push(&g->aligned[g->aligned[target].v[q]], target))
                        return -1;
                g->leader[target] = g->leader[nid];
            }
        }
        if (fresh) {
            run[nrun++] = target;
        } else if (nrun) {
            place_run(g, run, nrun, g->leader[target]);
            nrun = 0;
        }
        if (prev >= 0 && prev != target && add_edge(g, prev, target)) return -1;
        prev = target;
        path[m++] = target;
    }
    if (nrun) place_run(g, run, nrun, -1);
    return m;
}

/* The MSA of n reads (seqs concatenated, lens[i] bases each), the first
 * read first: n rows of *ncols letters or '-', in *out (malloc'd; free
 * with poa_free).  Returns 0, -1 where memory ran out, -2 where a read is
 * longer than MAX_LEN. */
int poa_msa(int n, const char *seqs, const int *lens, int tiebreak_ef,
            char **out, int *ncols) {
    graph g;
    dp_rows dp;
    memset(&g, 0, sizeof g);
    memset(&dp, 0, sizeof dp);
    g.head = g.tail = -1;
    int total = 0, lmax = 0, rc = -1;
    for (int i = 0; i < n; i++) {
        total += lens[i];
        if (lens[i] > lmax) lmax = lens[i];
    }
    *out = NULL;
    *ncols = 0;
    if (lmax > MAX_LEN) return -2;
    int *paths = malloc(((size_t)total + 1) * sizeof(int));
    int *run = malloc(((size_t)lmax + 1) * sizeof(int));
    int *an = NULL, *ap = NULL, *col = NULL;
    if (!paths || !run) goto done;
    const char *s = seqs;
    for (int i = 0, off = 0; i < n; i++) {
        size_t room = (size_t)g.n + lens[i] + 1;
        int k = 0;
        free(an); free(ap);
        an = malloc(room * sizeof(int));
        ap = malloc(room * sizeof(int));
        if (!an || !ap) goto done;
        if (align(&g, s, lens[i], tiebreak_ef, &dp, an, ap, &k)) goto done;
        if (add_alignment(&g, s, an, ap, k, paths + off, run) != lens[i])
            goto done;
        off += lens[i];
        s += lens[i];
    }
    /* one column a group, in the group order */
    col = malloc(((size_t)g.n + 1) * sizeof(int));
    if (!col) goto done;
    int c = 0;
    for (int x = g.head; x >= 0; x = g.next[x]) col[x] = c++;
    char *rows = malloc((size_t)n * c + 1);
    if (!rows) goto done;
    memset(rows, '-', (size_t)n * c);
    for (int i = 0, off = 0; i < n; i++) {
        for (int q = 0; q < lens[i]; q++) {
            int x = paths[off + q];
            rows[(size_t)i * c + col[g.leader[x]]] = g.letter[x];
        }
        off += lens[i];
    }
    *out = rows;
    *ncols = c;
    rc = 0;
done:
    free(paths); free(run); free(an); free(ap); free(col);
    free(dp.H); free(dp.E); free(dp.F);
    graph_free(&g);
    return rc;
}

void poa_free(char *p) { free(p); }
