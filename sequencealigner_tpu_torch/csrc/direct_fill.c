/* Direct scatter of launch groups into the score store: tiles-v2 tiles and
 * diagonal-remainder blocks, and linear-v1 superblocks.  Scores from a
 * launch group's host buffer (int16 when `wide` is 0, else int32)
 * straight into a plain-layout store, `matrix` (dim x dim when `tri` is 0,
 * else packed triangular at j(j-1)/2 + i, i < j), with no per-pair index
 * arrays.  Rows and lanes are bucket rows in length-sorted order, mapped to
 * original indices through `order`; `lengths` are the sorted lengths.
 * Each function returns the true DP cells of the pairs it wrote, and runs
 * on `nthreads` threads: the caller and helpers of a pool that this file
 * keeps, which take tiles, blocks or runs of slots in turn.  Between
 * groups the helpers sleep on a condition variable: none waits spinning
 * beside the engine's own threads, as an OpenMP team's idle workers do.
 *
 * Loaded through ctypes by io/direct_fill.py, which builds it with
 * gcc -O3 -march=native -pthread -shared -fPIC.
 */

#include <pthread.h>
#include <stdint.h>

#define TILE 128 /* TILE_S = TILE_B: rows and lanes of a tile */
#define TRI_W (TILE * (TILE - 1) / 2)

static inline int32_t score_at(const void *s, int wide, int64_t x) {
    return wide ? ((const int32_t *)s)[x] : ((const int16_t *)s)[x];
}

static inline void put(int32_t *matrix, int64_t dim, int tri, int64_t a,
                       int64_t b, int32_t v) {
    if (tri) {
        const int64_t i = a < b ? a : b, j = a < b ? b : a;
        matrix[j * (j - 1) / 2 + i] = v;
    } else {
        matrix[a * dim + b] = v;
    }
}

/* One tile: rows c0 + r of the c bucket against lanes kt*TILE + l of the k
 * bucket, scores row-major at s[r * TILE + l].  Valid: rows and lanes
 * inside their buckets and, within one bucket, lane < row. */
static inline int64_t scatter_tile(
    const void *s, int wide, int64_t c0, int64_t kt, const int64_t *order,
    const int32_t *lengths, int64_t c_start, int64_t c_count,
    int64_t k_start, int64_t k_count, int same, int32_t *matrix,
    int64_t dim, int tri) {
    int64_t oc[TILE], ok[TILE], pk[TILE + 1];
    const int64_t k0 = kt * TILE;
    int64_t nr = c_count - c0, nl = k_count - k0;
    nr = nr < TILE ? nr : TILE;
    nl = nl < TILE ? nl : TILE;
    if (nr <= 0 || nl <= 0)
        return 0;
    for (int64_t r = 0; r < nr; r++)
        oc[r] = order[c_start + c0 + r];
    pk[0] = 0;
    for (int64_t l = 0; l < nl; l++) {
        ok[l] = order[k_start + k0 + l];
        pk[l + 1] = pk[l] + lengths[k_start + k0 + l];
    }
    int64_t cells = 0;
    for (int64_t r = 0; r < nr; r++) {
        /* Row r's lanes: l < le. */
        int64_t le = nl;
        if (same) {
            le = c0 + r - k0;
            le = le < 0 ? 0 : (le < nl ? le : nl);
        }
        cells += (int64_t)lengths[c_start + c0 + r] * pk[le];
        if (tri) {
            for (int64_t l = 0; l < le; l++)
                put(matrix, dim, 1, oc[r], ok[l],
                    score_at(s, wide, r * TILE + l));
        } else {
            /* Row oc[r] of the matrix. */
            int32_t *row = matrix + oc[r] * dim;
            for (int64_t l = 0; l < le; l++)
                row[ok[l]] = score_at(s, wide, r * TILE + l);
        }
    }
    if (!tri) {
        /* The mirror, lane by lane: row ok[l] of the matrix. */
        for (int64_t l = 0; l < nl; l++) {
            /* Lane l's rows: r >= rb. */
            int64_t rb = same ? k0 + l - c0 + 1 : 0;
            rb = rb > 0 ? rb : 0;
            int32_t *row = matrix + ok[l] * dim;
            for (int64_t r = rb; r < nr; r++)
                row[oc[r]] = score_at(s, wide, r * TILE + l);
        }
    }
    return cells;
}

/* One launch group: its scores, its units (tiles, diagonal blocks or runs
 * of a linear-v1 block's slots) and the store; `next` is the next unit to
 * take, shared by the group's threads. */
typedef struct {
    const void *s;
    int wide, tri;
    const int32_t *desc;   /* tiles: (c0, kt) a tile */
    const int64_t *starts; /* diagonal, linear blocks: first slot a block */
    const int64_t *nvalid; /* linear blocks: valid slots a block */
    int64_t n, width;
    const int64_t *order;
    const int32_t *lengths;
    int64_t c_start, c_count, k_start, k_count;
    int32_t *matrix;
    int64_t dim;
    int64_t next;
} group_t;

typedef int64_t (*unit_fn)(const group_t *, int64_t);

typedef struct {
    group_t *g;
    unit_fn unit;
    int64_t cells;
} worker_t;

static void *work(void *arg) {
    worker_t *w = arg;
    group_t *g = w->g;
    int64_t u;
    while ((u = __atomic_fetch_add(&g->next, 1, __ATOMIC_RELAXED)) < g->n)
        w->cells += w->unit(g, u);
    return NULL;
}

/* The helpers: helper k (1 <= k <= pool_size) takes pool_w[k] of each
 * group posted while k < pool_want, and leaves it by lowering pool_busy.
 * One group at a time (call_mu). */
enum { MAX_TEAM = 256 };
static pthread_mutex_t call_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_mutex_t pool_mu = PTHREAD_MUTEX_INITIALIZER;
static pthread_cond_t pool_go = PTHREAD_COND_INITIALIZER;
static pthread_cond_t pool_done = PTHREAD_COND_INITIALIZER;
static int pool_size, pool_want, pool_busy;
static uint64_t pool_gen;           /* groups posted */
static uint64_t pool_born[MAX_TEAM]; /* pool_gen when helper k started */
static worker_t *pool_w;

static void *helper(void *arg) {
    const int k = (int)(intptr_t)arg;
    pthread_mutex_lock(&pool_mu);
    uint64_t seen = pool_born[k];
    for (;;) {
        while (pool_gen == seen)
            pthread_cond_wait(&pool_go, &pool_mu);
        seen = pool_gen;
        if (k >= pool_want)
            continue;
        worker_t *w = &pool_w[k];
        pthread_mutex_unlock(&pool_mu);
        work(w);
        pthread_mutex_lock(&pool_mu);
        if (--pool_busy == 0)
            pthread_cond_signal(&pool_done);
    }
    return NULL;
}

/* A child of fork() has none of its parent's helpers. */
static void pool_forget(void) {
    pthread_mutex_init(&call_mu, NULL);
    pthread_mutex_init(&pool_mu, NULL);
    pthread_cond_init(&pool_go, NULL);
    pthread_cond_init(&pool_done, NULL);
    pool_size = pool_want = pool_busy = 0;
}

/* unit(g, u) for every u < g->n on the caller and up to nthreads - 1
 * helpers, started when first needed; where one cannot be started, the
 * others take its units.  The cells of all units. */
static int64_t run_group(group_t *g, unit_fn unit, int32_t nthreads) {
    worker_t w[MAX_TEAM];
    nthreads = nthreads < 1 ? 1 : (nthreads > MAX_TEAM ? MAX_TEAM : nthreads);
    g->next = 0;
    for (int k = 0; k < nthreads; k++)
        w[k] = (worker_t){g, unit, 0};
    pthread_mutex_lock(&call_mu);
    pthread_mutex_lock(&pool_mu);
    if (pool_size == 0 && nthreads > 1)
        pthread_atfork(NULL, NULL, pool_forget);
    while (pool_size < nthreads - 1) {
        pthread_t tid;
        pool_born[pool_size + 1] = pool_gen;
        if (pthread_create(&tid, NULL, helper,
                           (void *)(intptr_t)(pool_size + 1)))
            break;
        pthread_detach(tid);
        pool_size++;
    }
    const int helpers = pool_size < nthreads - 1 ? pool_size : nthreads - 1;
    if (helpers > 0) {
        pool_w = w;
        pool_want = helpers + 1;
        pool_busy = helpers;
        pool_gen++;
        pthread_cond_broadcast(&pool_go);
    }
    pthread_mutex_unlock(&pool_mu);
    work(&w[0]);
    pthread_mutex_lock(&pool_mu);
    while (pool_busy > 0)
        pthread_cond_wait(&pool_done, &pool_mu);
    pthread_mutex_unlock(&pool_mu);
    pthread_mutex_unlock(&call_mu);
    int64_t cells = 0;
    for (int k = 0; k <= helpers; k++)
        cells += w[k].cells;
    return cells;
}

static int64_t tile_unit(const group_t *g, int64_t t) {
    const char *st = (const char *)g->s + t * TILE * TILE * (g->wide ? 4 : 2);
    const int same = g->c_start == g->k_start; /* buckets never overlap */
    /* A constant `wide` a call, so each inner loop reads one width. */
    return g->wide
        ? scatter_tile(st, 1, g->desc[2 * t], g->desc[2 * t + 1], g->order,
                       g->lengths, g->c_start, g->c_count, g->k_start,
                       g->k_count, same, g->matrix, g->dim, g->tri)
        : scatter_tile(st, 0, g->desc[2 * t], g->desc[2 * t + 1], g->order,
                       g->lengths, g->c_start, g->c_count, g->k_start,
                       g->k_count, same, g->matrix, g->dim, g->tri);
}

/* A launch group of `ntiles` tiles, tile t at desc[2t] = c0 (first c row),
 * desc[2t + 1] = kt (lane window), its scores at s[t * TILE * TILE ...]. */
int64_t scatter_tiles(const void *s, int32_t wide, const int32_t *desc,
                      int64_t ntiles, const int64_t *order,
                      const int32_t *lengths, int64_t c_start,
                      int64_t c_count, int64_t k_start, int64_t k_count,
                      int32_t *matrix, int64_t dim, int32_t tri,
                      int32_t nthreads) {
    group_t g = {.s = s, .wide = wide, .tri = tri, .desc = desc,
                 .n = ntiles, .order = order, .lengths = lengths,
                 .c_start = c_start, .c_count = c_count, .k_start = k_start,
                 .k_count = k_count, .matrix = matrix, .dim = dim};
    return run_group(&g, tile_unit, nthreads);
}

/* Diagonal block b of a group: `width` slots from starts[b] of the bucket
 * whose rows are c_start .. c_start + c_count of the sorted order, its
 * scores at s[b * width ...].  Slot t is window u = t / TRI_W and local
 * triangle id j(j-1)/2 + i, i < j: rows u*TILE + j and u*TILE + i; slots
 * past the bucket's rows are invalid. */
static int64_t diag_unit(const group_t *g, int64_t b) {
    const int64_t lo = g->starts[b], hi = lo + g->width;
    const int64_t *order = g->order;
    const int32_t *lengths = g->lengths;
    int64_t cells = 0;
    for (int64_t u = lo / TRI_W; u * TRI_W < hi; u++) {
        const int64_t m = g->c_count - u * TILE; /* rows of this window */
        const int64_t jmax = m < TILE ? m : TILE;
        const int64_t base = u * TRI_W;
        for (int64_t j = 1; j < jmax; j++) {
            int64_t a = base + j * (j - 1) / 2, e = a + j;
            const int64_t i0 = (a < lo ? lo : a) - a;
            e = e < hi ? e : hi;
            if (a + i0 >= e)
                continue;
            const int64_t sc = g->c_start + u * TILE + j;
            const int64_t oc = order[sc];
            const int64_t lc = lengths[sc];
            for (int64_t i = i0; a + i < e; i++) {
                const int64_t sk = g->c_start + u * TILE + i;
                const int32_t v = score_at(g->s, g->wide,
                                           b * g->width + a + i - lo);
                put(g->matrix, g->dim, g->tri, oc, order[sk], v);
                if (!g->tri)
                    put(g->matrix, g->dim, 0, order[sk], oc, v);
                cells += lc * lengths[sk];
            }
        }
    }
    return cells;
}

/* A launch group of `nblocks` diagonal-remainder blocks of one bucket
 * (rows b_start .. b_start + count of the sorted order), each `width`
 * slots from starts[b] (diag_unit). */
int64_t scatter_diag(const void *s, int32_t wide, const int64_t *starts,
                     int64_t nblocks, int64_t width, const int64_t *order,
                     const int32_t *lengths, int64_t b_start, int64_t count,
                     int32_t *matrix, int64_t dim, int32_t tri,
                     int32_t nthreads) {
    group_t g = {.s = s, .wide = wide, .tri = tri, .starts = starts,
                 .n = nblocks, .width = width, .order = order,
                 .lengths = lengths, .c_start = b_start, .c_count = count,
                 .matrix = matrix, .dim = dim};
    return run_group(&g, diag_unit, nthreads);
}

/* (j, i) of triangle id `lin` = j(j-1)/2 + i, 0 <= i < j, in integers:
 * j = (1 + isqrt(1 + 8 lin)) / 2, the square root digit by digit, then
 * the +-1 correction. */
static inline void tri_row(int64_t lin, int64_t *j, int64_t *i) {
    uint64_t x = 1 + 8 * (uint64_t)lin, r = 0, bit = (uint64_t)1 << 62;
    while (bit > x)
        bit >>= 2;
    for (; bit; bit >>= 2) {
        if (x >= r + bit) {
            x -= r + bit;
            r = (r >> 1) + bit;
        } else {
            r >>= 1;
        }
    }
    int64_t jj = (int64_t)(1 + r) / 2;
    while (jj * (jj - 1) / 2 > lin)
        jj--;
    while ((jj + 1) * jj / 2 <= lin)
        jj++;
    *j = jj;
    *i = lin - jj * (jj - 1) / 2;
}

/* Slots of a linear-v1 block that one unit takes. */
#define LIN_RUN 4096

/* Unit u of a linear-v1 group: slots [r * LIN_RUN, (r + 1) * LIN_RUN) of
 * block b, u = b * runs + r, cut at the block's valid slots.  Slot t is
 * combo-local pair id starts[b] + t: of one bucket (c_start == k_start),
 * the triangle id rc(rc-1)/2 + rk, rk < rc; of two, rc * k_count + rk.
 * The first slot's rows are inverted, the rest follow by counting. */
static int64_t linear_unit(const group_t *g, int64_t u) {
    const int64_t runs = (g->width + LIN_RUN - 1) / LIN_RUN;
    const int64_t b = u / runs, lo = u % runs * LIN_RUN;
    int64_t hi = lo + LIN_RUN;
    hi = hi < g->nvalid[b] ? hi : g->nvalid[b];
    if (lo >= hi)
        return 0;
    const int same = g->c_start == g->k_start; /* buckets never overlap */
    const int64_t *order = g->order;
    const int32_t *lengths = g->lengths;
    const int64_t lin = g->starts[b] + lo;
    int64_t rc, rk;
    if (same) {
        tri_row(lin, &rc, &rk);
    } else {
        rc = lin / g->k_count;
        rk = lin % g->k_count;
    }
    int64_t end = same ? rc : g->k_count, cells = 0; /* rk < end */
    for (int64_t t = lo; t < hi; t++) {
        const int64_t sc = g->c_start + rc, sk = g->k_start + rk;
        const int64_t oc = order[sc], ok = order[sk];
        const int32_t v = score_at(g->s, g->wide, b * g->width + t);
        put(g->matrix, g->dim, g->tri, oc, ok, v);
        if (!g->tri)
            put(g->matrix, g->dim, 0, ok, oc, v);
        cells += (int64_t)lengths[sc] * lengths[sk];
        if (++rk == end) {
            rc++;
            rk = 0;
            end = same ? rc : end;
        }
    }
    return cells;
}

/* A launch group of `nblocks` linear-v1 blocks of one combo, each `width`
 * slots from combo-local pair id starts[b], the first nvalid[b] valid;
 * the c bucket's rows from c_start of the sorted order, the k bucket's
 * k_count rows from k_start (linear_unit). */
int64_t scatter_linear(const void *s, int32_t wide, const int64_t *starts,
                       const int64_t *nvalid, int64_t nblocks, int64_t width,
                       const int64_t *order, const int32_t *lengths,
                       int64_t c_start, int64_t k_start, int64_t k_count,
                       int32_t *matrix, int64_t dim, int32_t tri,
                       int32_t nthreads) {
    group_t g = {.s = s, .wide = wide, .tri = tri, .starts = starts,
                 .nvalid = nvalid,
                 .n = nblocks * ((width + LIN_RUN - 1) / LIN_RUN),
                 .width = width, .order = order, .lengths = lengths,
                 .c_start = c_start, .k_start = k_start, .k_count = k_count,
                 .matrix = matrix, .dim = dim};
    return run_group(&g, linear_unit, nthreads);
}
