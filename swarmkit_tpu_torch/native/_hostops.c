/* Native host-runtime hot loops.
 *
 * The CUDA kernels (ops/, csrc/) own the placement math; this module owns
 * the host-side bookkeeping loop that commits a scheduler wave onto the
 * per-node NodeInfo tables (scheduler/batch.py apply_placements).  At
 * 1M placements the pure-Python segment walk spends ~1.2 s in
 * interpreter overhead (attribute chases, per-object dict ops); this C
 * walk does the same work through the CPython API with each task's id
 * fetched exactly once and by-service counts bumped once per
 * (node, group) run.  The Python implementation stays as the reference
 * oracle and fallback — tests assert bit-identical results
 * (tests/test_torch_native.py).
 *
 * Reference analogue: the per-task updateNodeInfo walk in
 * manager/scheduler/scheduler.go:330-346 (Go pays a cheap struct walk;
 * CPython needs native help to match it).
 *
 * Semantics mirrored exactly from batch.apply_placements:
 *   per node segment [a,b) of the node-major-sorted wave:
 *     - None info (node removed between encode and commit): skipped,
 *       uncounted;
 *     - any id collision with tasks already on the node: the whole
 *       segment goes through the Python fallback callable (per-task
 *       NodeInfo.add_task, which does its own bookkeeping);
 *     - otherwise: tasks dict inserts, mutations/active counters += k,
 *       exact per-node int64 resource decrements, and by-service
 *       Counter increments keyed by each task's group service id.
 *
 * GIL discipline (the async commit plane): these walks run
 * on a background commit worker overlapping the scheduler's next wave
 * (ops/commit.py), so a single multi-ms GIL-held C call would starve
 * the wave loop it is supposed to hide under.  Two measures:
 *   - apply_wave's counting sort + aggregate passes touch only C
 *     buffers and run with the GIL RELEASED;
 *   - the object walks drop-and-reacquire the GIL between node
 *     segments every YIELD_TASKS tasks — legal because the commit
 *     plane's contract already guarantees nothing else touches the
 *     wave's NodeInfos/lists until the worker barrier, and each walk
 *     call is reentrant per call (no module-level mutable state), so
 *     concurrent walks on DISJOINT info sets are safe
 *     (tests/test_torch_native.py pins both).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

static PyObject *s_tasks, *s_id, *s_mutations, *s_active, *s_avail,
    *s_svccnt, *s_mem, *s_cpus;

/* between-segment GIL yield cadence for the object walks: ~24 yields
 * per 200k-task wave — enough for the wave loop to interleave, cheap
 * enough (~1 us each) to vanish in the walk */
#define YIELD_TASKS 8192

/* ---------------------------------------------------------------- *
 * Segment-walk prefetch pipeline.
 *
 * The walk is MEMORY-bound, not op-bound: each node's Python objects
 * (NodeInfo, its instance dict, the tasks dict, the by-service
 * Counter) live on scattered heap lines that are cold by the time the
 * node-major walk reaches them — measured ~400-500 ns per by-service
 * bump at the 100k x 10k shape, almost all of it miss latency.  The
 * segments are short (~10 tasks, ~1-2 us each), which is exactly the
 * distance a staged software prefetch can hide: while node j walks,
 * stage A pulls node j+2's NodeInfo header (whose line holds the
 * instance-dict pointer), stage B pulls node j+1's instance dict, and
 * stage C (at entry to j) pulls j's dict key/value tables.  Reading
 * ma_keys/ma_values goes through the public (non-limited-API)
 * PyDictObject layout; the loads behind it only run after the dict
 * line was prefetched a full segment earlier. */
#if defined(__GNUC__) || defined(__clang__)
#define PF_READ(p) __builtin_prefetch((p), 0, 3)
#else
#define PF_READ(p) ((void)(p))
#endif

/* stage A: the object header line (first 64B covers ob_type and, for
 * plain dataclass instances, sits one line before/at the dict slot) */
static inline void
pf_stage_obj(PyObject *obj)
{
    if (obj != NULL && obj != Py_None)
        PF_READ(obj);
}

/* stage B: the instance dict object (its header holds ma_keys /
 * ma_values).  The info header was prefetched a stage earlier, so the
 * dictoffset load here is near-free. */
static inline void
pf_stage_dict(PyObject *obj)
{
    Py_ssize_t off;
    PyObject *d;

    if (obj == NULL || obj == Py_None)
        return;
    off = Py_TYPE(obj)->tp_dictoffset;
    if (off <= 0)
        return;
    d = *(PyObject **)((char *)obj + off);
    if (d != NULL)
        PF_READ(d);
}

/* stage C: the dict's key table and (split dicts — what dataclass
 * instances sharing one __init__ get) the values array, where the
 * tasks/counter/resources pointers live. */
static inline void
pf_stage_tables(PyObject *obj)
{
    Py_ssize_t off;
    PyObject *d;

    if (obj == NULL || obj == Py_None)
        return;
    off = Py_TYPE(obj)->tp_dictoffset;
    if (off <= 0)
        return;
    d = *(PyObject **)((char *)obj + off);
    if (d == NULL || !PyDict_Check(d))
        return;
    PF_READ(((PyDictObject *)d)->ma_keys);
    if (((PyDictObject *)d)->ma_values != NULL)
        PF_READ(((PyDictObject *)d)->ma_values);
}

/* obj.<attr> += delta for plain Python-int attributes. */
static int
add_int_attr(PyObject *obj, PyObject *attr, long long delta)
{
    PyObject *cur, *nv;
    long long v;

    if (delta == 0)
        return 0;
    cur = PyObject_GetAttr(obj, attr);
    if (cur == NULL)
        return -1;
    v = PyLong_AsLongLong(cur);
    Py_DECREF(cur);
    if (v == -1 && PyErr_Occurred())
        return -1;
    nv = PyLong_FromLongLong(v + delta);
    if (nv == NULL)
        return -1;
    if (PyObject_SetAttr(obj, attr, nv) < 0) {
        Py_DECREF(nv);
        return -1;
    }
    Py_DECREF(nv);
    return 0;
}

/* counter[key] += delta on a dict (Counter is a dict subclass; missing
 * key counts as 0, matching Counter semantics). */
static int
bump_counter(PyObject *counter, PyObject *key, long long delta)
{
    PyObject *cur, *nv;
    long long v = 0;

    cur = PyDict_GetItemWithError(counter, key);    /* borrowed */
    if (cur == NULL) {
        if (PyErr_Occurred())
            return -1;
    } else {
        v = PyLong_AsLongLong(cur);
        if (v == -1 && PyErr_Occurred())
            return -1;
    }
    nv = PyLong_FromLongLong(v + delta);
    if (nv == NULL)
        return -1;
    if (PyDict_SetItem(counter, key, nv) < 0) {
        Py_DECREF(nv);
        return -1;
    }
    Py_DECREF(nv);
    return 0;
}

/* ---------------------------------------------------------------- *
 * Plain-attribute fast path.
 *
 * The per-node tail of the walk (mutations/active counters, the two
 * resource decrements, the tasks/counter fetches) went through
 * PyObject_GetAttr/SetAttr — ~11 descriptor-protocol round trips per
 * node, which at the 100k x 10k north-star shape is HALF the walk
 * (the per-task inserts are the other half).  NodeInfo and Resources
 * are plain dataclasses, so the same reads/writes can go straight at
 * the instance dict — but only when that is provably identical to
 * attribute access: the type must use the generic tp_getattro/
 * tp_setattro AND have no descriptor (property, slot, classvar
 * descriptor) shadowing any touched name.  The check runs once per
 * distinct type per call; any miss (absent key, non-int value,
 * exotic type) falls back to the real attribute protocol, so
 * semantics never change — tests pin bit-parity against the Python
 * walk either way.                                                   */

static int
plain_attr(PyTypeObject *tp, PyObject *key)
{
    PyObject *c = _PyType_Lookup(tp, key);   /* borrowed */

    return c == NULL || (Py_TYPE(c)->tp_descr_get == NULL
                         && Py_TYPE(c)->tp_descr_set == NULL);
}

typedef struct {
    PyTypeObject *info_tp;      /* last vetted types (1-entry caches:  */
    int info_ok;                /* every wave's infos share one class) */
    PyTypeObject *res_tp;
    int res_ok;
} FastCheck;

static int
info_fast_ok(FastCheck *fc, PyObject *info)
{
    PyTypeObject *tp = Py_TYPE(info);

    if (fc->info_tp != tp) {
        fc->info_tp = tp;
        fc->info_ok = tp->tp_getattro == PyObject_GenericGetAttr
            && tp->tp_setattro == PyObject_GenericSetAttr
            && tp->tp_dictoffset != 0
            && plain_attr(tp, s_tasks) && plain_attr(tp, s_mutations)
            && plain_attr(tp, s_active) && plain_attr(tp, s_avail)
            && plain_attr(tp, s_svccnt);
    }
    return fc->info_ok;
}

static int
res_fast_ok(FastCheck *fc, PyObject *res)
{
    PyTypeObject *tp = Py_TYPE(res);

    if (fc->res_tp != tp) {
        fc->res_tp = tp;
        fc->res_ok = tp->tp_getattro == PyObject_GenericGetAttr
            && tp->tp_setattro == PyObject_GenericSetAttr
            && tp->tp_dictoffset != 0
            && plain_attr(tp, s_mem) && plain_attr(tp, s_cpus);
    }
    return fc->res_ok;
}

/* d[key] += delta for exact-int entries. 0 = done, 1 = not applicable
 * (absent / non-int — caller takes the attribute path), -1 = error. */
static int
add_int_key(PyObject *d, PyObject *key, long long delta)
{
    PyObject *cur, *nv;
    long long v;

    if (delta == 0)
        return 0;
    cur = PyDict_GetItemWithError(d, key);   /* borrowed */
    if (cur == NULL)
        return PyErr_Occurred() ? -1 : 1;
    if (!PyLong_CheckExact(cur))
        return 1;
    v = PyLong_AsLongLong(cur);
    if (v == -1 && PyErr_Occurred())
        return -1;
    nv = PyLong_FromLongLong(v + delta);
    if (nv == NULL)
        return -1;
    if (PyDict_SetItem(d, key, nv) < 0) {
        Py_DECREF(nv);
        return -1;
    }
    Py_DECREF(nv);
    return 0;
}

/* info.<key> += delta via the instance dict when legal, else the
 * attribute protocol. */
static int
bump_int_field(PyObject *obj, PyObject *idict, PyObject *key,
               long long delta)
{
    if (idict != NULL) {
        int rc = add_int_key(idict, key, delta);

        if (rc <= 0)
            return rc;
    }
    return add_int_attr(obj, key, delta);
}

/* Fetch obj.<key> — borrowed from the instance dict when possible,
 * else a NEW reference via GetAttr; *owned says which. NULL = error
 * or genuinely absent (error set by GetAttr). */
static PyObject *
fetch_field(PyObject *obj, PyObject *idict, PyObject *key, int *owned)
{
    if (idict != NULL) {
        PyObject *v = PyDict_GetItemWithError(idict, key);

        if (v != NULL) {
            *owned = 0;
            return v;
        }
        if (PyErr_Occurred())
            return NULL;
    }
    *owned = 1;
    return PyObject_GetAttr(obj, key);
}

/* The per-node commit tail shared by both walks: mutations/active
 * counters += k, exact resource decrements on available_resources.
 * Returns 0/-1. */
/* Borrow an object's instance dict: the instance (kept alive by the
 * caller's argument structures) owns a reference for as long as we
 * use it — same contract as borrowed dict items. NULL = no dict /
 * fast path not applicable. */
static PyObject *
borrow_instance_dict(PyObject *obj)
{
    PyObject *d = PyObject_GenericGetDict(obj, NULL);

    if (d == NULL) {
        PyErr_Clear();
        return NULL;
    }
    Py_DECREF(d);
    return d;
}

static int
commit_node_counters(PyObject *info, PyObject *idict, FastCheck *fc,
                     Py_ssize_t k, int64_t mem, int64_t cpu)
{
    PyObject *ar, *adict = NULL;
    int ar_owned = 0, rc = 0;

    if (bump_int_field(info, idict, s_mutations, (long long)k) < 0
        || bump_int_field(info, idict, s_active, (long long)k) < 0)
        return -1;
    if (mem == 0 && cpu == 0)
        return 0;
    ar = fetch_field(info, idict, s_avail, &ar_owned);
    if (ar == NULL)
        return -1;
    if (!ar_owned)
        Py_INCREF(ar);  /* the attr-fallback bumps below can run user
                         * descriptor code that could rebind the field
                         * — never hold it borrowed across them */
    if (res_fast_ok(fc, ar))
        adict = borrow_instance_dict(ar);
    if (bump_int_field(ar, adict, s_mem, -(long long)mem) < 0
        || bump_int_field(ar, adict, s_cpus, -(long long)cpu) < 0)
        rc = -1;
    Py_DECREF(ar);
    return rc;
}

/* Hand one segment to the Python per-task path (borrowed task
 * pointers); returns tasks added, or -1 with an exception set. */
static long long
fallback_segment(PyObject *fallback, PyObject *info, PyObject **tasks,
                 Py_ssize_t k)
{
    PyObject *seg, *r;
    Py_ssize_t m;
    long long added;

    seg = PyTuple_New(k);
    if (seg == NULL)
        return -1;
    for (m = 0; m < k; m++) {
        Py_INCREF(tasks[m]);
        PyTuple_SET_ITEM(seg, m, tasks[m]);
    }
    r = PyObject_CallFunctionObjArgs(fallback, info, seg, NULL);
    Py_DECREF(seg);
    if (r == NULL)
        return -1;
    added = PyLong_AsLongLong(r);
    Py_DECREF(r);
    if (added == -1 && PyErr_Occurred())
        return -1;
    return added;
}

static PyObject *
apply_segments(PyObject *self, PyObject *args)
{
    PyObject *infos, *tasks_all, *ids_all, *svc_of, *fallback;
    Py_buffer oi_b, nodes_b, bounds_b, mem_b, cpu_b, gidx_b;
    const int64_t *oi, *nodes, *bounds, *mem, *cpu, *gidx;
    Py_ssize_t n_seg, n_infos, n_tasks, n_svc, si;
    Py_ssize_t since_yield = 0;
    long long n_added = 0;
    PyObject *ret = NULL;
    PyObject **ids = NULL;
    FastCheck fc = {NULL, 0, NULL, 0};

    if (!PyArg_ParseTuple(args, "O!O!O!y*y*y*y*y*y*O!O",
                          &PyList_Type, &infos, &PyList_Type, &tasks_all,
                          &PyList_Type, &ids_all,
                          &oi_b, &nodes_b, &bounds_b, &mem_b, &cpu_b,
                          &gidx_b, &PyList_Type, &svc_of, &fallback))
        return NULL;

    oi = (const int64_t *)oi_b.buf;
    nodes = (const int64_t *)nodes_b.buf;
    bounds = (const int64_t *)bounds_b.buf;
    mem = (const int64_t *)mem_b.buf;
    cpu = (const int64_t *)cpu_b.buf;
    gidx = (const int64_t *)gidx_b.buf;
    n_seg = (Py_ssize_t)(bounds_b.len / (Py_ssize_t)sizeof(int64_t)) - 1;
    n_infos = PyList_GET_SIZE(infos);
    n_tasks = PyList_GET_SIZE(tasks_all);
    n_svc = PyList_GET_SIZE(svc_of);

    if (oi_b.len != nodes_b.len || gidx_b.len != nodes_b.len
        || mem_b.len != cpu_b.len
        || PyList_GET_SIZE(ids_all) != n_tasks
        || mem_b.len != n_infos * (Py_ssize_t)sizeof(int64_t)) {
        PyErr_SetString(PyExc_ValueError, "apply_segments: length mismatch");
        goto done;
    }

    /* scratch: borrowed task pointers for the rare fallback gather
     * only — the happy path never touches it */
    ids = (PyObject **)PyMem_Malloc(
        (size_t)(n_tasks > 0 ? n_tasks : 1) * sizeof(PyObject *));
    if (ids == NULL) {
        PyErr_NoMemory();
        goto done;
    }

    for (si = 0; si < n_seg; si++) {
        int64_t a = bounds[si], b = bounds[si + 1], node;
        Py_ssize_t k = (Py_ssize_t)(b - a), m, run;
        PyObject *info, *tdict, *counter, *idict;
        int err = 0, owned;

        since_yield += k;
        if (since_yield >= YIELD_TASKS) {
            /* between segments no borrowed ref is held: let the wave
             * loop run (async commit plane overlap) */
            since_yield = 0;
            Py_BEGIN_ALLOW_THREADS
            Py_END_ALLOW_THREADS
        }

        if (a < 0 || b > (int64_t)n_tasks || a >= b) {
            PyErr_SetString(PyExc_ValueError,
                            "apply_segments: bad segment bounds");
            goto done;
        }
        node = nodes[a];
        if (node < 0 || node >= (int64_t)n_infos) {
            PyErr_SetString(PyExc_IndexError,
                            "apply_segments: node out of range");
            goto done;
        }
        info = PyList_GET_ITEM(infos, node);            /* borrowed */
        if (info == Py_None)
            continue;

        idict = info_fast_ok(&fc, info)
            ? borrow_instance_dict(info) : NULL;
        tdict = fetch_field(info, idict, s_tasks, &owned);
        if (tdict == NULL)
            goto done;
        if (!owned)
            Py_INCREF(tdict);       /* uniform DECREF on every exit */
        if (!PyDict_Check(tdict)) {
            Py_DECREF(tdict);
            PyErr_SetString(PyExc_TypeError,
                            "apply_segments: NodeInfo.tasks is not a dict");
            goto done;
        }

        /* SINGLE fused pass over the PARALLEL id list: one hash probe
         * per task (SetDefault) and — because the caller supplies ids
         * alongside tasks — the happy path never dereferences a task
         * OBJECT at all: the value pointer is stored into the dict
         * without being read.  That removes the per-task cold-object
         * miss chain that dominated the wave at 1M placements.
         * SetDefault never overwrites, so on ANY anomaly (id already on
         * the node, same id twice within the wave, same object twice)
         * the pre-existing entry is intact and the undo is exactly
         * "delete what we inserted", then the per-task Python fallback
         * re-applies the whole segment with oracle semantics. */
        {
            Py_ssize_t inserted = 0;
            int bad = 0;

            for (m = 0; m < k; m++) {
                PyObject *task, *tid, *existing;
                Py_ssize_t sz;

                if (oi[a + m] < 0 || oi[a + m] >= (int64_t)n_tasks) {
                    PyErr_SetString(PyExc_IndexError,
                                    "apply_segments: oi out of range");
                    err = 1;
                    break;
                }
#if defined(__GNUC__) || defined(__clang__)
                /* the wave walks ids in node-major order — a random walk
                 * over the creation-ordered id strings; start pulling
                 * the string header (where the cached hash lives) a few
                 * iterations ahead so SetDefault doesn't eat the full
                 * miss chain (bounds re-checked when consumed) */
                if (a + m + 8 < b && oi[a + m + 8] >= 0
                    && oi[a + m + 8] < (int64_t)n_tasks)
                    __builtin_prefetch(
                        PyList_GET_ITEM(ids_all, oi[a + m + 8]), 0, 1);
#endif
                task = PyList_GET_ITEM(tasks_all, oi[a + m]); /* borrowed */
                tid = PyList_GET_ITEM(ids_all, oi[a + m]);    /* borrowed */
                sz = PyDict_GET_SIZE(tdict);
                existing = PyDict_SetDefault(tdict, tid, task); /* borrowed */
                if (existing == NULL) {
                    err = 1;
                    break;
                }
                if (existing != task || PyDict_GET_SIZE(tdict) == sz) {
                    bad = 1;      /* collision or in-wave duplicate */
                    break;
                }
                inserted = m + 1;
            }
            if (err) {
                /* our inserts stay: the exception aborts the wave and
                 * the caller's contract is state-on-error undefined —
                 * matching the Python walk, which also raises mid-way */
                Py_DECREF(tdict);
                goto done;
            }
            if (bad) {
                long long added;

                for (m = 0; m < inserted; m++) {
                    /* every [0, inserted) key is distinct and ours */
                    if (PyDict_DelItem(
                            tdict,
                            PyList_GET_ITEM(ids_all, oi[a + m])) < 0) {
                        Py_DECREF(tdict);
                        goto done;
                    }
                }
                Py_DECREF(tdict);
                for (m = 0; m < k; m++) {       /* gather for fallback */
                    if (oi[a + m] < 0 || oi[a + m] >= (int64_t)n_tasks) {
                        PyErr_SetString(PyExc_IndexError,
                                        "apply_segments: oi out of range");
                        goto done;
                    }
                    ids[m] = PyList_GET_ITEM(tasks_all, oi[a + m]);
                }
                added = fallback_segment(fallback, info, ids, k);
                if (added < 0)
                    goto done;
                n_added += added;
                continue;
            }
        }

        counter = fetch_field(info, idict, s_svccnt, &owned);
        if (counter == NULL) {
            Py_DECREF(tdict);
            goto done;
        }
        if (!owned)
            Py_INCREF(counter);
        if (!PyDict_Check(counter)) {   /* Counter is a dict subclass */
            PyErr_SetString(PyExc_TypeError,
                            "apply_segments: by-service counts not a dict");
            err = 1;
        }

        /* pass 2b: one counter bump per (node, group) run (the sort is
         * node-major then group-stable, so equal gidx values are
         * contiguous within the segment) */
        run = 0;
        for (m = 0; !err && m <= k; m++) {
            if (m == k || gidx[a + m] != gidx[a + run]) {
                int64_t g = gidx[a + run];

                if (g < 0 || g >= (int64_t)n_svc) {
                    PyErr_SetString(PyExc_IndexError,
                                    "apply_segments: gidx out of range");
                    err = 1;
                    break;
                }
                if (bump_counter(counter, PyList_GET_ITEM(svc_of, g),
                                 (long long)(m - run)) < 0) {
                    err = 1;
                    break;
                }
                run = m;
            }
        }
        Py_DECREF(tdict);
        Py_DECREF(counter);
        if (err)
            goto done;

        if (commit_node_counters(info, idict, &fc, k,
                                 mem[node], cpu[node]) < 0)
            goto done;
        n_added += (long long)k;
    }
    ret = PyLong_FromLongLong(n_added);

done:
    if (ids != NULL)
        PyMem_Free(ids);
    PyBuffer_Release(&oi_b);
    PyBuffer_Release(&nodes_b);
    PyBuffer_Release(&bounds_b);
    PyBuffer_Release(&mem_b);
    PyBuffer_Release(&cpu_b);
    PyBuffer_Release(&gidx_b);
    return ret;
}

/* ------------------------------------------------------------------ */
/* apply_wave: the whole wave commit in ONE native pass.
 *
 * apply_segments (above) still pays three numpy/Python stages before it
 * runs: concatenating per-group task/id lists (~100k list appends per
 * wave), a stable argsort to node-major order, and fancy-gathers of the
 * sorted companions — together roughly half the commit at the north-star
 * shape.  This entry replaces all of it: it takes the per-group lists
 * as-is plus each group's node-index vector, counting-sorts (node-major,
 * group-stable — identical order to np.argsort(..., kind="stable") on
 * the concatenation) in O(T + N), accumulates the per-node resource
 * aggregates in the same pass, and then walks segments with the same
 * fused SetDefault discipline and fallback semantics as apply_segments.
 *
 * groups: list of (tasks_list, ids_list, nodes_int64_buffer,
 *                  mem_per_task, cpu_per_task, service_id_obj)
 * Only "plain" groups belong here (no generic reservations / host ports
 * — the Python caller keeps those on the per-task path).
 */
static PyObject *
apply_wave_native(PyObject *self, PyObject *args)
{
    PyObject *infos, *groups, *fallback;
    Py_ssize_t n_infos, n_groups, g, T = 0;
    long long n_added = 0;
    PyObject *ret = NULL;
    /* per-group parsed views */
    PyObject **g_tasks = NULL, **g_ids = NULL, **g_svc = NULL;
    Py_buffer *g_bufs = NULL;
    const int64_t **g_nodes = NULL;
    Py_ssize_t *g_len = NULL;
    int64_t *g_mem = NULL, *g_cpu = NULL;
    int n_bufs = 0;
    /* wave-sized scratch */
    int64_t *cnt = NULL, *off = NULL, *mem_acc = NULL, *cpu_acc = NULL;
    int64_t *nz_nodes = NULL;
    Py_ssize_t n_nz = 0;
    int32_t *slot_g = NULL, *slot_m = NULL;
    PyObject **fb_tasks = NULL;

    if (!PyArg_ParseTuple(args, "O!O!O", &PyList_Type, &infos,
                          &PyList_Type, &groups, &fallback))
        return NULL;
    n_infos = PyList_GET_SIZE(infos);
    n_groups = PyList_GET_SIZE(groups);

    g_tasks = PyMem_Calloc((size_t)(n_groups ? n_groups : 1),
                           sizeof(PyObject *));
    g_ids = PyMem_Calloc((size_t)(n_groups ? n_groups : 1),
                         sizeof(PyObject *));
    g_svc = PyMem_Calloc((size_t)(n_groups ? n_groups : 1),
                         sizeof(PyObject *));
    g_bufs = PyMem_Calloc((size_t)(n_groups ? n_groups : 1),
                          sizeof(Py_buffer));
    g_nodes = PyMem_Calloc((size_t)(n_groups ? n_groups : 1),
                           sizeof(int64_t *));
    g_len = PyMem_Calloc((size_t)(n_groups ? n_groups : 1),
                         sizeof(Py_ssize_t));
    g_mem = PyMem_Calloc((size_t)(n_groups ? n_groups : 1), sizeof(int64_t));
    g_cpu = PyMem_Calloc((size_t)(n_groups ? n_groups : 1), sizeof(int64_t));
    if (!g_tasks || !g_ids || !g_svc || !g_bufs || !g_nodes || !g_len
        || !g_mem || !g_cpu) {
        PyErr_NoMemory();
        goto done;
    }

    for (g = 0; g < n_groups; g++) {
        PyObject *e = PyList_GET_ITEM(groups, g);
        PyObject *nodes_obj;
        long long mv, cv;

        if (!PyTuple_Check(e) || PyTuple_GET_SIZE(e) != 6) {
            PyErr_SetString(PyExc_TypeError,
                            "apply_wave: group entry must be a 6-tuple");
            goto done;
        }
        g_tasks[g] = PyTuple_GET_ITEM(e, 0);
        g_ids[g] = PyTuple_GET_ITEM(e, 1);
        nodes_obj = PyTuple_GET_ITEM(e, 2);
        g_svc[g] = PyTuple_GET_ITEM(e, 5);
        if (!PyList_Check(g_tasks[g]) || !PyList_Check(g_ids[g])) {
            PyErr_SetString(PyExc_TypeError,
                            "apply_wave: tasks/ids must be lists");
            goto done;
        }
        mv = PyLong_AsLongLong(PyTuple_GET_ITEM(e, 3));
        cv = PyLong_AsLongLong(PyTuple_GET_ITEM(e, 4));
        if ((mv == -1 || cv == -1) && PyErr_Occurred())
            goto done;
        g_mem[g] = (int64_t)mv;
        g_cpu[g] = (int64_t)cv;
        if (PyObject_GetBuffer(nodes_obj, &g_bufs[g],
                               PyBUF_SIMPLE) < 0)
            goto done;
        n_bufs = (int)(g + 1);
        g_nodes[g] = (const int64_t *)g_bufs[g].buf;
        g_len[g] = g_bufs[g].len / (Py_ssize_t)sizeof(int64_t);
        if (g_len[g] != PyList_GET_SIZE(g_tasks[g])
            || g_len[g] != PyList_GET_SIZE(g_ids[g])) {
            PyErr_SetString(PyExc_ValueError,
                            "apply_wave: tasks/ids/nodes length mismatch");
            goto done;
        }
        T += g_len[g];
    }

    cnt = PyMem_Calloc((size_t)(n_infos ? n_infos : 1), sizeof(int64_t));
    off = PyMem_Malloc((size_t)(n_infos ? n_infos : 1) * sizeof(int64_t));
    mem_acc = PyMem_Calloc((size_t)(n_infos ? n_infos : 1),
                           sizeof(int64_t));
    cpu_acc = PyMem_Calloc((size_t)(n_infos ? n_infos : 1),
                           sizeof(int64_t));
    nz_nodes = PyMem_Malloc((size_t)(n_infos ? n_infos : 1)
                            * sizeof(int64_t));
    slot_g = PyMem_Malloc((size_t)(T ? T : 1) * sizeof(int32_t));
    slot_m = PyMem_Malloc((size_t)(T ? T : 1) * sizeof(int32_t));
    fb_tasks = PyMem_Malloc((size_t)(T ? T : 1) * sizeof(PyObject *));
    if (!cnt || !off || !mem_acc || !cpu_acc || !nz_nodes || !slot_g
        || !slot_m || !fb_tasks) {
        PyErr_NoMemory();
        goto done;
    }

    /* passes 1+2 touch only C buffers: run them with the GIL RELEASED
     * so the wave loop (encode/dispatch of the next wave) overlaps the
     * sort when this call rides the async commit plane */
    {
        int oob = 0;

        Py_BEGIN_ALLOW_THREADS
        /* pass 1: histogram + per-node resource aggregates */
        for (g = 0; g < n_groups && !oob; g++) {
            const int64_t *nv = g_nodes[g];
            Py_ssize_t m, len = g_len[g];
            int64_t gm = g_mem[g], gc = g_cpu[g];

            for (m = 0; m < len; m++) {
                int64_t node = nv[m];

                if (node < 0 || node >= (int64_t)n_infos) {
                    oob = 1;
                    break;
                }
                cnt[node]++;
                mem_acc[node] += gm;
                cpu_acc[node] += gc;
            }
        }
        if (!oob) {
            /* exclusive prefix: off[n] = start of node n's segment */
            int64_t acc = 0;
            Py_ssize_t n;

            for (n = 0; n < n_infos; n++) {
                off[n] = acc;
                acc += cnt[n];
            }
            /* pass 2: stable scatter into node-major slots (group order
             * is the concatenation order, so equal nodes keep group-
             * stable order — exactly np.argsort(kind="stable") on the
             * concatenated vector) */
            for (g = 0; g < n_groups; g++) {
                const int64_t *nv = g_nodes[g];
                Py_ssize_t m, len = g_len[g];

                for (m = 0; m < len; m++) {
                    int64_t s = off[nv[m]]++;

                    slot_g[s] = (int32_t)g;
                    slot_m[s] = (int32_t)m;
                }
            }
            /* compact nonzero-node list: pass 3 walks it directly, which
             * both skips the empty nodes and gives the prefetch pipeline
             * a lookahead index */
            for (n = 0; n < n_infos; n++)
                if (cnt[n])
                    nz_nodes[n_nz++] = n;
        }
        Py_END_ALLOW_THREADS
        if (oob) {
            PyErr_SetString(PyExc_IndexError,
                            "apply_wave: node index out of range");
            goto done;
        }
    }
    /* off[n] is now the segment END for node n; start = off[n] - cnt[n] */

    /* pass 3: per-node segment walk (same semantics as apply_segments) */
    {
        Py_ssize_t node, j;
        Py_ssize_t since_yield = 0;
        FastCheck fc = {NULL, 0, NULL, 0};

        for (j = 0; j < n_nz; j++) {
            int64_t k64;
            Py_ssize_t a, k;
            Py_ssize_t m, run;
            PyObject *info, *tdict, *counter, *idict;
            int err = 0, owned;

            node = (Py_ssize_t)nz_nodes[j];
            k64 = cnt[node];
            a = (Py_ssize_t)(off[node] - k64);
            k = (Py_ssize_t)k64;
            /* prefetch pipeline: object header two segments out, its
             * instance dict one segment out, this segment's dict
             * tables now (each stage's loads only touch lines an
             * earlier stage already pulled) */
            if (j + 2 < n_nz)
                pf_stage_obj(PyList_GET_ITEM(infos, nz_nodes[j + 2]));
            if (j + 1 < n_nz)
                pf_stage_dict(PyList_GET_ITEM(infos, nz_nodes[j + 1]));
            since_yield += k;
            if (since_yield >= YIELD_TASKS) {
                /* between segments no borrowed ref is held: let the
                 * wave loop run (async commit plane overlap) */
                since_yield = 0;
                Py_BEGIN_ALLOW_THREADS
                Py_END_ALLOW_THREADS
            }
            info = PyList_GET_ITEM(infos, node);        /* borrowed */
            if (info == Py_None)
                continue;
            pf_stage_tables(info);
            idict = info_fast_ok(&fc, info)
                ? borrow_instance_dict(info) : NULL;
            tdict = fetch_field(info, idict, s_tasks, &owned);
            if (tdict == NULL)
                goto done;
            if (!owned)
                Py_INCREF(tdict);   /* uniform DECREF on every exit */
            if (!PyDict_Check(tdict)) {
                Py_DECREF(tdict);
                PyErr_SetString(PyExc_TypeError,
                                "apply_wave: NodeInfo.tasks is not a dict");
                goto done;
            }
            {
                Py_ssize_t inserted = 0;
                int bad = 0;

                for (m = 0; m < k; m++) {
                    PyObject *task, *tid, *existing;
                    Py_ssize_t sz;
                    int32_t gg = slot_g[a + m], mm = slot_m[a + m];

#if defined(__GNUC__) || defined(__clang__)
                    if (m + 8 < k)
                        __builtin_prefetch(
                            PyList_GET_ITEM(g_ids[slot_g[a + m + 8]],
                                            slot_m[a + m + 8]), 0, 1);
#endif
                    task = PyList_GET_ITEM(g_tasks[gg], mm); /* borrowed */
                    tid = PyList_GET_ITEM(g_ids[gg], mm);    /* borrowed */
                    sz = PyDict_GET_SIZE(tdict);
                    existing = PyDict_SetDefault(tdict, tid, task);
                    if (existing == NULL) {
                        err = 1;
                        break;
                    }
                    if (existing != task || PyDict_GET_SIZE(tdict) == sz) {
                        bad = 1;
                        break;
                    }
                    inserted = m + 1;
                }
                if (err) {
                    Py_DECREF(tdict);
                    goto done;
                }
                if (bad) {
                    long long added;

                    for (m = 0; m < inserted; m++) {
                        if (PyDict_DelItem(
                                tdict,
                                PyList_GET_ITEM(g_ids[slot_g[a + m]],
                                                slot_m[a + m])) < 0) {
                            Py_DECREF(tdict);
                            goto done;
                        }
                    }
                    Py_DECREF(tdict);
                    for (m = 0; m < k; m++)
                        fb_tasks[m] = PyList_GET_ITEM(
                            g_tasks[slot_g[a + m]], slot_m[a + m]);
                    added = fallback_segment(fallback, info, fb_tasks, k);
                    if (added < 0)
                        goto done;
                    n_added += added;
                    continue;
                }
            }

            counter = fetch_field(info, idict, s_svccnt, &owned);
            if (counter == NULL) {
                Py_DECREF(tdict);
                goto done;
            }
            if (!owned)
                Py_INCREF(counter);
            if (!PyDict_Check(counter)) {
                PyErr_SetString(
                    PyExc_TypeError,
                    "apply_wave: by-service counts not a dict");
                err = 1;
            }
            run = 0;
            for (m = 0; !err && m <= k; m++) {
                if (m == k || slot_g[a + m] != slot_g[a + run]) {
                    if (bump_counter(counter,
                                     g_svc[slot_g[a + run]],
                                     (long long)(m - run)) < 0) {
                        err = 1;
                        break;
                    }
                    run = m;
                }
            }
            Py_DECREF(tdict);
            Py_DECREF(counter);
            if (err)
                goto done;

            if (commit_node_counters(info, idict, &fc, k,
                                     mem_acc[node], cpu_acc[node]) < 0)
                goto done;
            n_added += (long long)k;
        }
    }
    ret = PyLong_FromLongLong(n_added);

done:
    if (fb_tasks) PyMem_Free(fb_tasks);
    if (slot_m) PyMem_Free(slot_m);
    if (slot_g) PyMem_Free(slot_g);
    if (nz_nodes) PyMem_Free(nz_nodes);
    if (cpu_acc) PyMem_Free(cpu_acc);
    if (mem_acc) PyMem_Free(mem_acc);
    if (off) PyMem_Free(off);
    if (cnt) PyMem_Free(cnt);
    {
        int i;

        for (i = 0; i < n_bufs; i++)
            PyBuffer_Release(&g_bufs[i]);
    }
    if (g_cpu) PyMem_Free(g_cpu);
    if (g_mem) PyMem_Free(g_mem);
    if (g_len) PyMem_Free(g_len);
    if (g_nodes) PyMem_Free(g_nodes);
    if (g_bufs) PyMem_Free(g_bufs);
    if (g_svc) PyMem_Free(g_svc);
    if (g_ids) PyMem_Free(g_ids);
    if (g_tasks) PyMem_Free(g_tasks);
    return ret;
}

/* ------------------------------------------------------------------ */
/* tree_copy: fast deep copy for the store's closed object universe.
 *
 * StoreObject.copy() was copy.deepcopy — ~20-40 us per Task (memo dict,
 * reduce protocol) on a path the store walks two or three times per
 * write.  The replicated object model is TREE-shaped (no cycles, no
 * intentional aliasing between fields) and built from: immutables
 * (None/bool/int incl. IntEnum/float/str/bytes/Enum members/frozenset),
 * lists, dicts (immutable keys), sets (immutable elements), tuples, and
 * plain (non-__slots__) dataclasses.  Anything else in an `Any` field
 * falls through to the caller-provided fallback (copy.deepcopy), so
 * exotic payloads keep full deepcopy semantics subtree-wise.
 */
static PyObject *enum_class;          /* enum.Enum, cached at module init */
static PyObject *s_dc_fields;         /* "__dataclass_fields__"          */
static PyObject *empty_tuple;

static PyObject *
tree_copy_inner(PyObject *obj, PyObject *fallback)
{
    PyTypeObject *tp = Py_TYPE(obj);
    PyObject *result = NULL;
    int isinst;

    if (obj == Py_None || obj == Py_True || obj == Py_False
        || PyLong_Check(obj)            /* int + IntEnum members */
        || PyUnicode_Check(obj) || PyBytes_Check(obj)
        || PyFloat_Check(obj) || PyFrozenSet_CheckExact(obj)) {
        Py_INCREF(obj);
        return obj;
    }
    /* a cyclic object (contract breach) must fail as RecursionError,
     * not blow the C stack; single exit point pairs the Leave */
    if (Py_EnterRecursiveCall(" in swarmkit_tpu_torch tree_copy"))
        return NULL;

    if (PyList_CheckExact(obj)) {
        Py_ssize_t n = PyList_GET_SIZE(obj), i;
        PyObject *out = PyList_New(n);

        if (out == NULL)
            goto leave;
        for (i = 0; i < n; i++) {
            PyObject *c = tree_copy_inner(PyList_GET_ITEM(obj, i),
                                          fallback);
            if (c == NULL) {
                Py_DECREF(out);
                goto leave;
            }
            PyList_SET_ITEM(out, i, c);
        }
        result = out;
    } else if (PyDict_CheckExact(obj)) {
        PyObject *out = PyDict_New(), *k, *v;
        Py_ssize_t pos = 0;

        if (out == NULL)
            goto leave;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            PyObject *c = tree_copy_inner(v, fallback);

            if (c == NULL || PyDict_SetItem(out, k, c) < 0) {
                Py_XDECREF(c);
                Py_DECREF(out);
                goto leave;
            }
            Py_DECREF(c);
        }
        result = out;
    } else if (PyTuple_CheckExact(obj)) {
        Py_ssize_t n = PyTuple_GET_SIZE(obj), i;
        PyObject *out = PyTuple_New(n);

        if (out == NULL)
            goto leave;
        for (i = 0; i < n; i++) {
            PyObject *c = tree_copy_inner(PyTuple_GET_ITEM(obj, i),
                                          fallback);
            if (c == NULL) {
                Py_DECREF(out);
                goto leave;
            }
            PyTuple_SET_ITEM(out, i, c);
        }
        result = out;
    } else if (PySet_CheckExact(obj)) {
        /* deep-copy elements too: a mutable-but-hashable element in an
         * Any payload must not alias the original (deepcopy semantics) */
        PyObject *out = PySet_New(NULL), *it, *e;

        if (out == NULL)
            goto leave;
        it = PyObject_GetIter(obj);
        if (it == NULL) {
            Py_DECREF(out);
            goto leave;
        }
        while ((e = PyIter_Next(it)) != NULL) {
            PyObject *c = tree_copy_inner(e, fallback);

            Py_DECREF(e);
            if (c == NULL || PySet_Add(out, c) < 0) {
                Py_XDECREF(c);
                Py_DECREF(it);
                Py_DECREF(out);
                goto leave;
            }
            Py_DECREF(c);
        }
        Py_DECREF(it);
        if (PyErr_Occurred()) {         /* iterator failure */
            Py_DECREF(out);
            goto leave;
        }
        result = out;
    } else if ((isinst = PyObject_IsInstance(obj, enum_class)) != 0) {
        if (isinst > 0) {
            Py_INCREF(obj);             /* Enum members are singletons */
            result = obj;
        }                               /* isinst < 0: error set, leave */
    } else if (tp->tp_dictoffset != 0
               && PyObject_HasAttr((PyObject *)tp, s_dc_fields)) {
        /* plain dataclass: allocate without __init__, deep-copy the
         * instance dict */
        PyObject *inst, *src, *dst, *k, *v;
        Py_ssize_t pos = 0;

        inst = tp->tp_new(tp, empty_tuple, NULL);
        if (inst == NULL) {
            /* a base class whose __new__ needs arguments: outside the
             * plain-dataclass contract — fall back like every other
             * unknown shape */
            PyErr_Clear();
            result = PyObject_CallFunctionObjArgs(fallback, obj, NULL);
            goto leave;
        }
        src = PyObject_GenericGetDict(obj, NULL);
        dst = PyObject_GenericGetDict(inst, NULL);
        if (src == NULL || dst == NULL || !PyDict_Check(src)
            || !PyDict_Check(dst)) {
            Py_XDECREF(src);
            Py_XDECREF(dst);
            Py_DECREF(inst);
            PyErr_Clear();
            result = PyObject_CallFunctionObjArgs(fallback, obj, NULL);
            goto leave;
        }
        while (PyDict_Next(src, &pos, &k, &v)) {
            PyObject *c = tree_copy_inner(v, fallback);

            if (c == NULL || PyDict_SetItem(dst, k, c) < 0) {
                Py_XDECREF(c);
                Py_DECREF(src);
                Py_DECREF(dst);
                Py_DECREF(inst);
                goto leave;
            }
            Py_DECREF(c);
        }
        Py_DECREF(src);
        Py_DECREF(dst);
        result = inst;
    } else {
        result = PyObject_CallFunctionObjArgs(fallback, obj, NULL);
    }

leave:
    Py_LeaveRecursiveCall();
    return result;
}

static PyObject *
tree_copy(PyObject *self, PyObject *args)
{
    PyObject *obj, *fallback;

    if (!PyArg_ParseTuple(args, "OO", &obj, &fallback))
        return NULL;
    return tree_copy_inner(obj, fallback);
}

static PyMethodDef methods[] = {
    {"apply_segments", apply_segments, METH_VARARGS,
     "apply_segments(infos, tasks_all, oi, nodes_srt, seg_bounds, "
     "mem_by_node, cpu_by_node, gidx_srt, svc_of, fallback) -> added"},
    {"apply_wave", apply_wave_native, METH_VARARGS,
     "apply_wave(infos, groups, fallback) -> added; groups = list of "
     "(tasks, ids, nodes_int64, mem_per_task, cpu_per_task, service_id) "
     "— counting-sorts node-major in C and walks segments in one pass"},
    {"tree_copy", tree_copy, METH_VARARGS,
     "tree_copy(obj, fallback) -> deep copy of a tree-shaped object "
     "built from immutables/lists/dicts/sets/tuples/plain dataclasses; "
     "unknown subtrees go through fallback(subtree)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hostops",
    "Native host-runtime hot loops for swarmkit_tpu_torch", -1, methods,
};

PyMODINIT_FUNC
PyInit__hostops(void)
{
    PyObject *enum_mod;

    s_tasks = PyUnicode_InternFromString("tasks");
    s_id = PyUnicode_InternFromString("id");
    s_mutations = PyUnicode_InternFromString("mutations");
    s_active = PyUnicode_InternFromString("active_tasks_count");
    s_avail = PyUnicode_InternFromString("available_resources");
    s_svccnt = PyUnicode_InternFromString("active_tasks_count_by_service");
    s_mem = PyUnicode_InternFromString("memory_bytes");
    s_cpus = PyUnicode_InternFromString("nano_cpus");
    s_dc_fields = PyUnicode_InternFromString("__dataclass_fields__");
    if (!s_tasks || !s_id || !s_mutations || !s_active || !s_avail
        || !s_svccnt || !s_mem || !s_cpus || !s_dc_fields)
        return NULL;
    empty_tuple = PyTuple_New(0);
    if (empty_tuple == NULL)
        return NULL;
    enum_mod = PyImport_ImportModule("enum");
    if (enum_mod == NULL)
        return NULL;
    enum_class = PyObject_GetAttrString(enum_mod, "Enum");
    Py_DECREF(enum_mod);
    if (enum_class == NULL)
        return NULL;
    return PyModule_Create(&moduledef);
}
