/* The port's record core: one call a draw.
 *
 * RenderContext._record_draw's Python body (context.py) records a draw as
 * core/transform.aabb, core/transform.inverse, tuple glue and
 * CommandBuffer.append: some 10 us of float64 math and numpy row stores a
 * draw on the host.  record_draw() does the same in one call: the inverse
 * transform, the command box of the draw's mode, and the row stored
 * straight into the buffer's kinds and params.
 *
 * Bit for bit with the Python body: built with -ffp-contract=off, so
 * every double operation rounds on its own as CPython's float operations
 * do, in their order; mn/mx take their operands as Python's min/max
 * builtins do (the second wins only where strictly smaller / larger),
 * which fixes where a NaN goes; a NaN or an infinity raises where Python's
 * int() or math.floor() would, with the same exception type.  Python's
 * int arithmetic is exact where doubles round, so the core declines a
 * draw (returns False, storing nothing) whose matrix holds anything but
 * floats or whose geometry (gx, gy, gw, gh; a line's corners) holds
 * anything but floats and ints within 2**52: the Python body records
 * those.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

/* Python's min(u, v) and max(u, v) */
static inline double mn(double u, double v) { return v < u ? v : u; }
static inline double mx(double u, double v) { return v > u ? v : u; }
static inline long long mn_ll(long long u, long long v) { return v < u ? v : u; }
static inline long long mx_ll(long long u, long long v) { return v > u ? v : u; }

/* core/transform.trunc_clamp on a number that is not NaN: the clamp at
 * +-9e17 keeps the cast defined for every double, infinities included */
static inline long long trunc_ll(double v) {
    if (v > 9.0e17) v = 9.0e17;
    else if (v < -9.0e17) v = -9.0e17;
    return (long long)v;
}

static int nan_error(void) {
    PyErr_SetString(PyExc_ValueError, "cannot convert float NaN to integer");
    return -1;
}

/* math.floor's refusals: NaN raises ValueError, an infinity OverflowError */
static int floor_check(double v) {
    if (v != v) return nan_error();
    if (isinf(v)) {
        PyErr_SetString(PyExc_OverflowError,
                        "cannot convert float infinity to integer");
        return -1;
    }
    return 0;
}

/* A matrix entry: 1 and its value for a float, 0 for anything else */
static int take_float(PyObject *o, double *out) {
    if (!PyFloat_Check(o)) return 0;
    *out = PyFloat_AS_DOUBLE(o);
    return 1;
}

/* A number of the draw's geometry: 1 and its value for a float or an int
 * of at most 2**52 (sums of two of them are exact in double), 0 for
 * anything else */
static int take_geom(PyObject *o, double *out) {
    if (PyFloat_Check(o)) {
        *out = PyFloat_AS_DOUBLE(o);
        return 1;
    }
    if (PyLong_Check(o)) {
        int overflow;
        long long v = PyLong_AsLongLongAndOverflow(o, &overflow);
        if (overflow || v > (1LL << 52) || v < -(1LL << 52)) return 0;
        *out = (double)v;
        return 1;
    }
    return 0;
}

/* Append the n numbers of seq to row[*k..], at most cap in all;
 * -1 with an exception set on failure */
static int store_seq(PyObject *seq, double *row, Py_ssize_t *k,
                     Py_ssize_t cap, Py_ssize_t want) {
    PyObject *fast = PySequence_Fast(seq, "expected a sequence");
    if (!fast) return -1;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    if (want >= 0 && n != want) {
        Py_DECREF(fast);
        PyErr_Format(PyExc_ValueError, "expected %zd entries, got %zd",
                     want, n);
        return -1;
    }
    if (*k + n > cap) {
        Py_DECREF(fast);
        PyErr_Format(PyExc_ValueError,
                     "a row of %zd numbers does not fit in %zd",
                     *k + n, cap);
        return -1;
    }
    PyObject **items = PySequence_Fast_ITEMS(fast);
    for (Py_ssize_t j = 0; j < n; j++) {
        double v = PyFloat_AsDouble(items[j]);
        if (v == -1.0 && PyErr_Occurred()) {
            Py_DECREF(fast);
            return -1;
        }
        row[(*k)++] = v;
    }
    Py_DECREF(fast);
    return 0;
}

#define ROW_MAX 64

/* record_draw(kinds, params, i, kind, m6, ct4, mode, gx, gy, gw, gh,
 *             spec, mw, mh) -> bool
 *
 * Stores kinds[i] = kind and params[i] = inverse(m6) + box + ct4 + spec,
 * zeros to the row's end, and returns True; returns False, storing
 * nothing, where it declines the draw (see the head of this file).
 * kinds is int32 and params a row-contiguous (N, PARAM_W) float64 array.
 * The box of each mode (RenderContext._BOX_*):
 *   0  core/transform.aabb(m6, gx, gy, gw, gh, mw, mh): the corners'
 *      min/max truncated and clamped to [0, mw] x [0, mh]
 *   1  (trunc(gx), gx + gw, trunc(gy), gy + gh), not clamped: the
 *      texture blit's fast path
 *   2  the AABB of spec[0:8]'s four corners mapped through m6, as
 *      (floor(min), max + 1) clamped to [0, mw] x [0, mh]: draw_line
 *   3  (0, mw, 0, mh), and any other mode too */
static PyObject *record_draw(PyObject *self, PyObject *const *args,
                             Py_ssize_t nargs) {
    (void)self;
    if (nargs != 14) {
        PyErr_Format(PyExc_TypeError,
                     "record_draw takes 14 arguments (%zd given)", nargs);
        return NULL;
    }
    PyObject *kinds_o = args[0], *params_o = args[1], *m_o = args[4];
    PyObject *ct_o = args[5], *spec_o = args[11];
    Py_ssize_t i = PyLong_AsSsize_t(args[2]);
    if (i == -1 && PyErr_Occurred()) return NULL;
    long kind = PyLong_AsLong(args[3]);
    if (kind == -1 && PyErr_Occurred()) return NULL;
    long mode = PyLong_AsLong(args[6]);
    if (mode == -1 && PyErr_Occurred()) return NULL;
    double mw = PyFloat_AsDouble(args[12]);
    if (mw == -1.0 && PyErr_Occurred()) return NULL;
    double mh = PyFloat_AsDouble(args[13]);
    if (mh == -1.0 && PyErr_Occurred()) return NULL;

    double m[6], g[4];
    {
        PyObject *fast = PySequence_Fast(m_o, "the matrix must be a sequence");
        if (!fast) return NULL;
        if (PySequence_Fast_GET_SIZE(fast) != 6) {
            Py_DECREF(fast);
            PyErr_SetString(PyExc_ValueError, "the matrix must have 6 entries");
            return NULL;
        }
        PyObject **items = PySequence_Fast_ITEMS(fast);
        int all = 1;
        for (int k = 0; k < 6 && all; k++) all = take_float(items[k], &m[k]);
        Py_DECREF(fast);
        if (!all) Py_RETURN_FALSE;
    }
    for (int k = 0; k < 4; k++)
        if (!take_geom(args[7 + k], &g[k])) Py_RETURN_FALSE;
    double gx = g[0], gy = g[1], gw = g[2], gh = g[3];
    double a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5];

    double row[ROW_MAX];
    /* the inverse (core/transform.inverse: det == 0 takes inv_det = 1e9) */
    double det = a * d - b * c;
    double inv_det = det != 0.0 ? 1.0 / det : 1e9;
    row[0] = d * inv_det;
    row[1] = -b * inv_det;
    row[2] = -c * inv_det;
    row[3] = a * inv_det;
    row[4] = (c * f - d * e) * inv_det;
    row[5] = (b * e - a * f) * inv_det;

    /* the box */
    if (mode == 0) {
        double xw = gx + gw, yh = gy + gh;
        double ltx = a * gx + c * gy + e, lty = b * gx + d * gy + f;
        double rtx = a * xw + c * gy + e, rty = b * xw + d * gy + f;
        double lbx = a * gx + c * yh + e, lby = b * gx + d * yh + f;
        double rbx = a * xw + c * yh + e, rby = b * xw + d * yh + f;
        double lf = mn(mn(ltx, rtx), mn(lbx, rbx));
        double rf = mx(mx(ltx, rtx), mx(lbx, rbx));
        double tf = mn(mn(lty, rty), mn(lby, rby));
        double bf = mx(mx(lty, rty), mx(lby, rby));
        if (lf != lf || rf != rf || tf != tf || bf != bf) {
            nan_error();
            return NULL;
        }
        long long mwi = (long long)mw, mhi = (long long)mh;
        row[6] = (double)mx_ll(0, mn_ll(mwi, trunc_ll(lf)));
        row[7] = (double)mx_ll(0, mn_ll(mwi, trunc_ll(rf)));
        row[8] = (double)mx_ll(0, mn_ll(mhi, trunc_ll(tf)));
        row[9] = (double)mx_ll(0, mn_ll(mhi, trunc_ll(bf)));
    } else if (mode == 1) {
        if (gx != gx || gy != gy) {
            nan_error();
            return NULL;
        }
        row[6] = (double)trunc_ll(gx);
        row[7] = gx + gw;
        row[8] = (double)trunc_ll(gy);
        row[9] = gy + gh;
    } else if (mode == 2) {
        PyObject *fast = PySequence_Fast(spec_o, "the spec must be a sequence");
        if (!fast) return NULL;
        if (PySequence_Fast_GET_SIZE(fast) < 8) {
            Py_DECREF(fast);
            PyErr_SetString(PyExc_IndexError, "list index out of range");
            return NULL;
        }
        PyObject **items = PySequence_Fast_ITEMS(fast);
        double txl = 0, txh = 0, tyl = 0, tyh = 0;
        for (int k = 0; k < 4; k++) {
            double px, py;
            if (!take_geom(items[2 * k], &px) ||
                    !take_geom(items[2 * k + 1], &py)) {
                Py_DECREF(fast);
                Py_RETURN_FALSE;
            }
            double cx = a * px + c * py + e;
            double cy = b * px + d * py + f;
            if (k == 0) {
                txl = txh = cx;
                tyl = tyh = cy;
            } else {
                txl = mn(txl, cx); txh = mx(txh, cx);
                tyl = mn(tyl, cy); tyh = mx(tyh, cy);
            }
        }
        Py_DECREF(fast);
        /* Python floors min(tx) first, then min(ty) */
        if (floor_check(txl) < 0 || floor_check(tyl) < 0) return NULL;
        row[6] = mx(0.0, mn(mw, floor(txl)));
        row[7] = mx(0.0, mn(mw, txh + 1.0));
        row[8] = mx(0.0, mn(mh, floor(tyl)));
        row[9] = mx(0.0, mn(mh, tyh + 1.0));
    } else {
        row[6] = 0.0;
        row[7] = mw;
        row[8] = 0.0;
        row[9] = mh;
    }

    /* the colour transform and the draw's own numbers */
    Py_ssize_t nrow = 10;
    if (store_seq(ct_o, row, &nrow, ROW_MAX, 4) < 0) return NULL;
    if (spec_o != Py_None && store_seq(spec_o, row, &nrow, ROW_MAX, -1) < 0)
        return NULL;

    Py_buffer kb, pb;
    if (PyObject_GetBuffer(kinds_o, &kb, PyBUF_RECORDS) < 0) return NULL;
    if (PyObject_GetBuffer(params_o, &pb, PyBUF_RECORDS) < 0) {
        PyBuffer_Release(&kb);
        return NULL;
    }
    PyObject *result = NULL;
    if (kb.ndim != 1 || kb.itemsize != 4 || strcmp(kb.format, "i") != 0 ||
            pb.ndim != 2 || pb.itemsize != 8 || pb.strides[1] != 8 ||
            strcmp(pb.format, "d") != 0) {
        PyErr_SetString(PyExc_TypeError,
                        "kinds must be 1D int32 and params 2D row-contiguous "
                        "float64");
        goto done;
    }
    if (i < 0 || i >= kb.shape[0] || i >= pb.shape[0]) {
        PyErr_SetString(PyExc_IndexError, "row index out of range");
        goto done;
    }
    Py_ssize_t width = pb.shape[1];
    if (nrow > width) {
        PyErr_Format(PyExc_ValueError,
                     "a row of %zd numbers does not fit in %zd", nrow, width);
        goto done;
    }
    *(int32_t *)((char *)kb.buf + i * kb.strides[0]) = (int32_t)kind;
    double *dst = (double *)((char *)pb.buf + i * pb.strides[0]);
    Py_ssize_t k = 0;
    for (; k < nrow; k++) dst[k] = row[k];
    for (; k < width; k++) dst[k] = 0.0;
    result = Py_NewRef(Py_True);
done:
    PyBuffer_Release(&kb);
    PyBuffer_Release(&pb);
    return result;
}

static PyMethodDef methods[] = {
    {"record_draw", (PyCFunction)(void (*)(void))record_draw, METH_FASTCALL,
     "record_draw(kinds, params, i, kind, m6, ct4, mode, gx, gy, gw, gh, "
     "spec, mw, mh) -> bool: record one draw into row i (see record.c)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "record",
    .m_doc = "The port's record core: one call a draw (csrc/record.c).",
    .m_size = -1,
    .m_methods = methods,
};

PyMODINIT_FUNC PyInit_record(void) { return PyModule_Create(&module); }
