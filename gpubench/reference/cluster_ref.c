/* The scalar loops of the plain reference of RATTLE's clustering
 * (cluster.py beside this file), called through ctypes.
 *
 *   gate   the bitvector pre-gate of cluster.cpp:12-65: a pair's common
 *          6-mers over the larger of its two reads' counts, at least thr
 *   decide the score and variance gates of cluster.cpp:12-65 on each
 *          candidate pair: its matches, every (pos1, pos2) of equal hashes
 *          by (pos1, pos2) (kmer.cpp:45-67), from an index of the
 *          candidates' k-mers by hash; then lis_one
 *   lis    lis_one over given match lists
 *
 * lis_one is similarity.cpp:4-97 with the sample variance of utils.cpp:26-55.
 * Built with -ffp-contract=off, so that the variance rounds as the
 * reference's doubles do, step by step. */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define BV_WORDS 64 /* 4096 bits of 6-mer presence */

/* candidates whose bits stay in the cache while every seed passes them */
#define TILE 64

#if defined(__x86_64__)
__attribute__((target("popcnt")))
#endif
void gate(int n_seeds, int m, const uint64_t *seed_bits,
          const int32_t *seed_count, const uint64_t *bits,
          const int32_t *count, double thr, uint8_t *cand)
{
    for (int j0 = 0; j0 < m; j0 += TILE) {
        int j1 = j0 + TILE < m ? j0 + TILE : m;
        for (int b = 0; b < n_seeds; b++) {
            const uint64_t *s = seed_bits + (int64_t)b * BV_WORDS;
            uint8_t *c = cand + (int64_t)b * m;
            for (int j = j0; j < j1; j++) {
                if (!c[j])
                    continue;
                int most = seed_count[b], least = count[j];
                if (least > most) {
                    most = count[j];
                    least = seed_count[b];
                }
                /* common <= least: no need to count where that fails */
                if ((double)least / (double)most < thr) {
                    c[j] = 0;
                    continue;
                }
                const uint64_t *r = bits + (int64_t)j * BV_WORDS;
                int common = 0;
                for (int w = 0; w < BV_WORDS; w++)
                    common += __builtin_popcountll(s[w] & r[w]);
                c[j] = (double)common / (double)most >= thr;
            }
        }
    }
}

/* utils.cpp:26-55: var([]) = 0, var([x]) = 0 / 0 = NaN */
static double variance(int n, const int32_t *d)
{
    if (n == 0)
        return 0.0;
    double sum = 0.0;
    for (int i = 0; i < n; i++)
        sum += (double)d[i];
    double mean = sum / (double)n, ss = 0.0, comp = 0.0;
    for (int i = 0; i < n; i++) {
        double dv = (double)d[i] - mean;
        ss += dv * dv;
        comp += dv;
    }
    return (ss - comp * comp / (double)n) / (double)(n - 1);
}

typedef struct {
    int32_t *pred, *top, *tails, *seq, *dist;
    int64_t room;
} Scratch;

static void scratch_free(Scratch *s)
{
    free(s->pred);
    free(s->top);
    free(s->tails);
    free(s->seq);
    free(s->dist);
    memset(s, 0, sizeof *s);
}

static int scratch_reserve(Scratch *s, int64_t n)
{
    if (s->pred && n <= s->room)
        return 0;
    scratch_free(s);
    size_t size = (size_t)(n + 1) * sizeof(int32_t);
    s->pred = malloc(size);
    s->top = malloc(size);
    s->tails = malloc(size);
    s->seq = malloc(size);
    s->dist = malloc(size);
    if (!s->pred || !s->top || !s->tails || !s->seq || !s->dist) {
        scratch_free(s);
        return -1;
    }
    s->room = n;
    return 0;
}

/* similarity.cpp:4-97 on one pair's n matches (m1, m2), sorted by (m1, m2):
 * the patience LIS, strictly increasing in m2; of its elements, those on
 * the same side of k as the last kept one in both reads are kept, each
 * adding k bases less its overlap with the previous LIS element (not the
 * previous kept one); the variance of the kept elements' distances. */
static void lis_one(int64_t n, const int32_t *m1, const int32_t *m2, int k,
                    Scratch *s, int32_t *bases, double *var)
{
    int32_t *pred = s->pred, *top = s->top, *tails = s->tails, *seq = s->seq;
    int32_t *dist = s->dist;
    int len = 0;
    top[0] = 0;
    for (int64_t i = 0; i < n; i++) {
        int32_t v = m2[i];
        int lo = 1, hi = len + 1; /* the first level whose tail is >= v */
        while (lo < hi) {
            int mid = (lo + hi) / 2;
            if (tails[mid] < v)
                lo = mid + 1;
            else
                hi = mid;
        }
        pred[i] = top[lo - 1];
        top[lo] = (int32_t)i;
        tails[lo] = v;
        if (lo > len)
            len = lo;
    }
    for (int i = len - 1, j = len ? top[len] : 0; i >= 0; i--) {
        seq[i] = j;
        j = pred[j];
    }
    int32_t b = len ? k : 0;
    int nd = 0;
    int32_t lf = len ? m1[seq[0]] : 0, ls = len ? m2[seq[0]] : 0;
    for (int i = 1; i < len; i++) {
        int32_t a1 = m1[seq[i]], a2 = m2[seq[i]];
        int32_t d1 = a1 - lf, d2 = a2 - ls;
        if ((d1 < k && d2 < k) || (d1 >= k && d2 >= k)) {
            int32_t ex = k - (a2 - m2[seq[i - 1]]);
            b += ex > 0 ? k - ex : k;
            dist[nd++] = d2 - d1;
            lf = a1;
            ls = a2;
        }
    }
    *bases = b;
    *var = variance(nd, dist);
}

/* Pair p's matches are m1, m2 [off[p], off[p + 1]). */
int lis(int n_pairs, const int64_t *off, const int32_t *m1, const int32_t *m2,
        int k, int32_t *bases, double *var)
{
    Scratch s = {0};
    for (int p = 0; p < n_pairs; p++) {
        if (scratch_reserve(&s, off[p + 1] - off[p]))
            return -1;
        lis_one(off[p + 1] - off[p], m1 + off[p], m2 + off[p], k, &s,
                bases + p, var + p);
    }
    scratch_free(&s);
    return 0;
}

/* For each seed b (its k-mers q_hash, at q_pos ascending, [q_off[b],
 * q_off[b + 1])) and each candidate j with cand[b * m + j]: whether the
 * pair's bases over the shorter read's length reach t_s and the variance
 * stays under t_v, written over cand.  The index lists the candidates'
 * k-mers of hash h as (e_cand, e_pos) [start[h], start[h + 1]), by
 * (candidate, position); so a pair's matches come out by (pos1, pos2).
 * cap > 0 keeps each pair's first cap. */
int decide(int n_seeds, int m, const int64_t *q_off, const int32_t *q_hash,
           const int32_t *q_pos, const int64_t *seed_len,
           const int64_t *start, const int32_t *e_cand, const int32_t *e_pos,
           const int64_t *len, int k, int cap, double t_s, double t_v,
           uint8_t *cand)
{
    int32_t *count = malloc((size_t)(m + 1) * sizeof *count);
    int64_t *at = malloc((size_t)(m + 1) * sizeof *at);
    int32_t *m1 = NULL, *m2 = NULL;
    int64_t room = 0;
    Scratch s = {0};
    int rc = -1;
    if (!count || !at)
        goto done;
    for (int b = 0; b < n_seeds; b++) {
        uint8_t *c = cand + (int64_t)b * m;
        memset(count, 0, (size_t)m * sizeof *count);
        for (int64_t q = q_off[b]; q < q_off[b + 1]; q++) {
            if (q + 16 < q_off[b + 1])
                __builtin_prefetch(start + q_hash[q + 16]);
            for (int64_t e = start[q_hash[q]]; e < start[q_hash[q] + 1]; e++)
                count[e_cand[e]] += c[e_cand[e]];
        }
        int64_t total = 0, most = 0;
        for (int j = 0; j < m; j++) {
            at[j] = total;
            total += count[j];
            if (count[j] > most)
                most = count[j];
        }
        if (total > room) {
            free(m1);
            free(m2);
            m1 = malloc((size_t)total * sizeof *m1);
            m2 = malloc((size_t)total * sizeof *m2);
            room = total;
            if (!m1 || !m2)
                goto done;
        }
        if (scratch_reserve(&s, cap > 0 && most > cap ? cap : most))
            goto done;
        for (int64_t q = q_off[b]; q < q_off[b + 1]; q++) {
            if (q + 16 < q_off[b + 1])
                __builtin_prefetch(start + q_hash[q + 16]);
            for (int64_t e = start[q_hash[q]]; e < start[q_hash[q] + 1]; e++) {
                int32_t j = e_cand[e];
                if (c[j]) {
                    m1[at[j]] = q_pos[q];
                    m2[at[j]++] = e_pos[e];
                }
            }
        }
        for (int j = 0; j < m; j++) {
            if (!c[j])
                continue;
            int64_t n = count[j], first = at[j] - n;
            if (cap > 0 && n > cap)
                n = cap;
            int32_t bases;
            double var;
            lis_one(n, m1 + first, m2 + first, k, &s, &bases, &var);
            int64_t shorter = seed_len[b] < len[j] ? seed_len[b] : len[j];
            c[j] = (double)bases / (double)shorter >= t_s && var < t_v;
        }
    }
    rc = 0;
done:
    free(count);
    free(at);
    free(m1);
    free(m2);
    scratch_free(&s);
    return rc;
}
