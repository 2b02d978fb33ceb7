/* Native host kernels for the preprocessing of sfft_tpu_torch (a copy of
 * sfft_tpu/native/_native.cc).
 *
 * Replaces the reference's two vendored Cython extensions with a single C++
 * CPython extension (plain C API, no pybind11):
 *   - hough_accum: straight-line Hough accumulator hot loop
 *     (reference sfft/utils/houghLine/_hough_transform.pyx:61-96)
 *   - ccl_label: two-pass union-find connected-component labeling
 *     (reference sfft/utils/houghLine/_ccomp.pyx)
 *
 * Rounding matches skimage 0.16-0.18 semantics: round half away from zero
 * (the reference pins that behavior; sfft/utils/HoughDetection.py:73-101).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cmath>
#include <cstdint>
#include <vector>

static inline npy_intp round_half_away(double x) {
    return (npy_intp)(x >= 0.0 ? x + 0.5 : x - 0.5);
}

/* hough_accum(x_idxs int64[n], y_idxs int64[n], ctheta f64[m], stheta f64[m],
 *             max_distance int) -> uint64[max_distance, m] */
static PyObject *hough_accum(PyObject *self, PyObject *args) {
    PyArrayObject *xs, *ys, *ct, *st;
    long max_distance;
    if (!PyArg_ParseTuple(args, "O!O!O!O!l", &PyArray_Type, &xs, &PyArray_Type,
                          &ys, &PyArray_Type, &ct, &PyArray_Type, &st,
                          &max_distance))
        return NULL;

    PyArrayObject *xc = (PyArrayObject *)PyArray_FROM_OTF(
        (PyObject *)xs, NPY_INT64, NPY_ARRAY_IN_ARRAY);
    PyArrayObject *yc = (PyArrayObject *)PyArray_FROM_OTF(
        (PyObject *)ys, NPY_INT64, NPY_ARRAY_IN_ARRAY);
    PyArrayObject *ctc = (PyArrayObject *)PyArray_FROM_OTF(
        (PyObject *)ct, NPY_FLOAT64, NPY_ARRAY_IN_ARRAY);
    PyArrayObject *stc = (PyArrayObject *)PyArray_FROM_OTF(
        (PyObject *)st, NPY_FLOAT64, NPY_ARRAY_IN_ARRAY);
    if (!xc || !yc || !ctc || !stc) return NULL;

    npy_intp n = PyArray_DIM(xc, 0);
    npy_intp m = PyArray_DIM(ctc, 0);
    npy_intp dims[2] = {(npy_intp)max_distance, m};
    PyArrayObject *accum =
        (PyArrayObject *)PyArray_ZEROS(2, dims, NPY_UINT64, 0);
    if (!accum) return NULL;

    const int64_t *px = (const int64_t *)PyArray_DATA(xc);
    const int64_t *py = (const int64_t *)PyArray_DATA(yc);
    const double *pct = (const double *)PyArray_DATA(ctc);
    const double *pst = (const double *)PyArray_DATA(stc);
    uint64_t *pa = (uint64_t *)PyArray_DATA(accum);
    npy_intp offset = max_distance / 2;

    Py_BEGIN_ALLOW_THREADS
    for (npy_intp i = 0; i < n; ++i) {
        double x = (double)px[i], y = (double)py[i];
        for (npy_intp j = 0; j < m; ++j) {
            npy_intp idx = round_half_away(pct[j] * x + pst[j] * y) + offset;
            if (idx >= 0 && idx < (npy_intp)max_distance) pa[idx * m + j] += 1;
        }
    }
    Py_END_ALLOW_THREADS

    Py_DECREF(xc);
    Py_DECREF(yc);
    Py_DECREF(ctc);
    Py_DECREF(stc);
    return (PyObject *)accum;
}

struct UnionFind {
    std::vector<int32_t> parent;
    int32_t find(int32_t a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];
            a = parent[a];
        }
        return a;
    }
    void unite(int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a < b)
            parent[b] = a;
        else if (b < a)
            parent[a] = b;
    }
};

/* ccl_label(mask uint8[h, w], connectivity int 1|2) -> (int32[h, w], nlabels) */
static PyObject *ccl_label(PyObject *self, PyObject *args) {
    PyArrayObject *mask;
    int connectivity = 2;
    if (!PyArg_ParseTuple(args, "O!|i", &PyArray_Type, &mask, &connectivity))
        return NULL;
    PyArrayObject *mc = (PyArrayObject *)PyArray_FROM_OTF(
        (PyObject *)mask, NPY_UINT8, NPY_ARRAY_IN_ARRAY);
    if (!mc) return NULL;

    npy_intp h = PyArray_DIM(mc, 0), w = PyArray_DIM(mc, 1);
    npy_intp dims[2] = {h, w};
    PyArrayObject *labels =
        (PyArrayObject *)PyArray_ZEROS(2, dims, NPY_INT32, 0);
    if (!labels) return NULL;

    const uint8_t *pm = (const uint8_t *)PyArray_DATA(mc);
    int32_t *pl = (int32_t *)PyArray_DATA(labels);
    int nlab = 0;

    {
        UnionFind uf;
        uf.parent.reserve(1024);
        std::vector<int32_t> provisional((size_t)(h * w), 0);

        Py_BEGIN_ALLOW_THREADS
        /* pass 1: provisional labels + unions */
        for (npy_intp r = 0; r < h; ++r) {
            for (npy_intp c = 0; c < w; ++c) {
                npy_intp k = r * w + c;
                if (!pm[k]) continue;
                int32_t lab = -1;
                /* scan prior neighbors */
                npy_intp nbrs[4][2] = {
                    {r, c - 1}, {r - 1, c}, {r - 1, c - 1}, {r - 1, c + 1}};
                int nn = (connectivity == 2) ? 4 : 2;
                for (int t = 0; t < nn; ++t) {
                    npy_intp rr = nbrs[t][0], cc = nbrs[t][1];
                    if (rr < 0 || cc < 0 || cc >= w) continue;
                    npy_intp kk = rr * w + cc;
                    if (!pm[kk]) continue;
                    int32_t nl = provisional[kk];
                    if (lab < 0)
                        lab = nl;
                    else
                        uf.unite(lab, nl);
                }
                if (lab < 0) {
                    lab = (int32_t)uf.parent.size();
                    uf.parent.push_back(lab);
                }
                provisional[k] = lab;
            }
        }
        /* pass 2: flatten + renumber 1..n */
        std::vector<int32_t> remap(uf.parent.size(), 0);
        for (size_t i = 0; i < uf.parent.size(); ++i) {
            int32_t root = uf.find((int32_t)i);
            if (remap[root] == 0 && (size_t)root == i) remap[root] = ++nlab;
        }
        for (npy_intp k = 0; k < h * w; ++k) {
            if (pm[k]) pl[k] = remap[uf.find(provisional[k])];
        }
        Py_END_ALLOW_THREADS
    }

    Py_DECREF(mc);
    return Py_BuildValue("Ni", (PyObject *)labels, nlab);
}

/* rice_decode(bytes, npix, blocksize) -> int32[npix]
 * RICE_1 decoder for BYTEPIX=4 (CFITSIO fits_rdecomp semantics). */
static PyObject *rice_decode(PyObject *self, PyObject *args) {
    const char *buf;
    Py_ssize_t buflen;
    long npix, blocksize;
    if (!PyArg_ParseTuple(args, "y#ll", &buf, &buflen, &npix, &blocksize))
        return NULL;
    npy_intp dims[1] = {npix};
    PyArrayObject *out = (PyArrayObject *)PyArray_ZEROS(1, dims, NPY_INT32, 0);
    if (!out) return NULL;
    int32_t *pout = (int32_t *)PyArray_DATA(out);

    const unsigned char *c = (const unsigned char *)buf;
    const unsigned char *cend = c + buflen;
    const int fsbits = 5, fsmax = 25, bbits = 32;

    /* first 4 bytes: initial pixel value, big-endian */
    if (buflen < 4) {
        PyErr_SetString(PyExc_ValueError, "rice stream too short");
        return NULL;
    }
    int32_t lastpix = ((int32_t)c[0] << 24) | ((int32_t)c[1] << 16) |
                      ((int32_t)c[2] << 8) | (int32_t)c[3];
    c += 4;

    unsigned int b = *c++;  /* bit buffer */
    int nbits = 8;
    npy_intp i = 0;
    while (i < npix) {
        /* read fsbits for this block */
        nbits -= fsbits;
        while (nbits < 0) {
            b = (b << 8) | (c < cend ? *c++ : 0);
            nbits += 8;
        }
        int fs = (int)((b >> nbits) & ((1 << fsbits) - 1)) - 1;
        b &= (1U << nbits) - 1;
        npy_intp imax = i + blocksize;
        if (imax > npix) imax = npix;
        if (fs < 0) {
            for (; i < imax; ++i) pout[i] = lastpix;
        } else if (fs == fsmax) {
            /* low-entropy escape: each diff stored as raw 32 bits */
            for (; i < imax; ++i) {
                uint32_t diff = 0;
                int k = bbits - nbits;
                if (k < 32) diff = (uint32_t)b << k;
                for (k -= 8; k >= 0; k -= 8) {
                    b = (c < cend ? *c++ : 0);
                    diff |= (uint32_t)b << k;
                }
                if (nbits > 0) {
                    /* the byte's top -k bits end this value; its low nbits
                     * (= -k) bits stay in the buffer (CFITSIO fits_rdecomp) */
                    b = (c < cend ? *c++ : 0);
                    diff |= (uint32_t)b >> (-k);
                    b &= (1U << nbits) - 1;
                } else {
                    b = 0;
                }
                int32_t d = (diff & 1) ? (int32_t)(~(diff >> 1))
                                       : (int32_t)(diff >> 1);
                lastpix = d + lastpix;
                pout[i] = lastpix;
            }
        } else {
            for (; i < imax; ++i) {
                /* unary-coded high part: count zeros up to the next 1 bit */
                while (b == 0) {
                    if (c >= cend) {
                        PyErr_SetString(PyExc_ValueError,
                                        "rice stream exhausted");
                        Py_DECREF(out);
                        return NULL;
                    }
                    nbits += 8;
                    b = *c++;
                }
                int msb = 31 - __builtin_clz(b); /* position of top set bit */
                int nzero = nbits - (msb + 1);
                nbits = msb;          /* zeros + the terminating 1 consumed */
                b &= (1U << nbits) - 1;
                /* fs low bits */
                nbits -= fs;
                while (nbits < 0) {
                    b = (b << 8) | (c < cend ? *c++ : 0);
                    nbits += 8;
                }
                uint32_t diff = ((uint32_t)nzero << fs) | (b >> nbits);
                b &= (1U << nbits) - 1;
                int32_t d = (diff & 1) ? (int32_t)(~(diff >> 1))
                                       : (int32_t)(diff >> 1);
                lastpix = d + lastpix;
                pout[i] = lastpix;
            }
        }
    }
    return (PyObject *)out;
}

static PyMethodDef Methods[] = {
    {"hough_accum", hough_accum, METH_VARARGS,
     "Straight-line Hough accumulator"},
    {"ccl_label", ccl_label, METH_VARARGS,
     "Union-find connected-component labeling"},
    {"rice_decode", rice_decode, METH_VARARGS,
     "RICE_1 decoder (BYTEPIX=4)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_native", NULL,
                                       -1, Methods};

PyMODINIT_FUNC PyInit__native(void) {
    import_array();
    return PyModule_Create(&moduledef);
}
