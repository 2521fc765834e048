/* xsarsea_tpu_torch._lutio — native LUT codec of the PyTorch port.
 *
 * A copy of the JAX package's codec (native/lutio.cpp), built as an
 * extension of its own so that the port never imports the JAX package.
 * Host-side file I/O, not a device kernel: record stripping, the
 * Fortran->C order permutation of the KNMI CMOD7 table (reference
 * cmod7.py:19-75), and the packed LUT cache format, each in one pass.
 *
 *   decode_cmod7(path) -> (51, 250, 73) float32 C-contiguous
 *       reads the KNMI little-endian Fortran table (250 wspd x 73 phi x
 *       51 inc with one 4-byte record head/tail) and emits the
 *       (incidence, wspd, phi) layout the inversion tables want.
 *
 *   write_packed(path, arr, meta) / read_packed(path) -> (arr, meta)
 *       "XSTL1" container: float32 C-order payload + JSON metadata,
 *       loaded with a single fread into the final buffer.
 *
 * xsarsea_tpu_torch/io/lut_io.py and models/cmod7.py use it when it is
 * importable and their Python paths otherwise; both give the same arrays
 * and the same files. Build: python setup.py build_ext --inplace
 */

#define PY_SSIZE_T_CLEAN
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <Python.h>
#include <numpy/arrayobject.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr char kMagic[6] = {'X', 'S', 'T', 'L', '1', '\n'};

struct FileCloser {
    std::FILE *f;
    ~FileCloser() { if (f) std::fclose(f); }
};

PyObject *decode_cmod7(PyObject *, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

    constexpr npy_intp M = 250, N = 73, P = 51;  // wspd, phi, incidence
    constexpr size_t n_vals = size_t(M) * N * P;

    std::FILE *f = std::fopen(path, "rb");
    if (!f) return PyErr_Format(PyExc_FileNotFoundError, "%s", path);
    FileCloser closer{f};

    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    /* EXACT size required — the pure-Python fallback's reshape rejects
     * any other total length, and the native path must never silently
     * decode a wrong-layout file the fallback would refuse. (The
     * Fortran record marker VALUE is not checked: test fixtures and
     * some distributions pad with zeros there.) */
    if (sz != long((n_vals + 2) * sizeof(float))) {
        return PyErr_Format(
            PyExc_ValueError,
            "%s: not a CMOD7 250x73x51 table (%ld bytes, expected %ld)",
            path, sz, long((n_vals + 2) * sizeof(float)));
    }
    std::fseek(f, sizeof(float), SEEK_SET);  // skip Fortran record head

    std::vector<float> raw(n_vals);
    if (std::fread(raw.data(), sizeof(float), n_vals, f) != n_vals) {
        return PyErr_Format(PyExc_IOError, "%s: short read", path);
    }

    npy_intp dims[3] = {P, M, N};  // (incidence, wspd, phi)
    PyObject *out = PyArray_SimpleNew(3, dims, NPY_FLOAT32);
    if (!out) return nullptr;
    float *dst = static_cast<float *>(PyArray_DATA((PyArrayObject *)out));

    /* raw is Fortran-ordered (M, N, P): raw[m + M*n + M*N*p].
     * dst is C-ordered (P, M, N): dst[n + N*m + N*M*p].
     * One pass, sequential reads, strided writes within a P-slab that
     * fits L2 (250*73*4 = 73 KB). */
    for (npy_intp p = 0; p < P; ++p) {
        const float *src_p = raw.data() + size_t(p) * M * N;
        float *dst_p = dst + size_t(p) * M * N;
        for (npy_intp n = 0; n < N; ++n) {
            const float *src = src_p + size_t(n) * M;
            for (npy_intp m = 0; m < M; ++m) {
                dst_p[size_t(m) * N + n] = src[m];
            }
        }
    }
    return out;
}

PyObject *write_packed(PyObject *, PyObject *args) {
    const char *path;
    PyObject *arr_obj;
    const char *meta;
    Py_ssize_t meta_len;
    if (!PyArg_ParseTuple(args, "sOs#", &path, &arr_obj, &meta, &meta_len))
        return nullptr;

    PyArrayObject *arr = (PyArrayObject *)PyArray_FROM_OTF(
        arr_obj, NPY_FLOAT32, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED);
    if (!arr) return nullptr;

    std::FILE *f = std::fopen(path, "wb");
    if (!f) {
        Py_DECREF(arr);
        return PyErr_Format(PyExc_IOError, "cannot write %s", path);
    }
    FileCloser closer{f};

    /* enforce the READER's limit at write time: files the writer can
     * produce must always be loadable (read_packed rejects mlen > 1 MiB,
     * and the uint32 cast below would silently truncate huge lengths) */
    if (meta_len < 0 || meta_len > (1 << 20)) {
        Py_DECREF(arr);
        return PyErr_Format(PyExc_ValueError,
                            "metadata too large (%zd bytes, limit 1 MiB)",
                            meta_len);
    }
    uint32_t mlen = uint32_t(meta_len);
    uint32_t ndim = uint32_t(PyArray_NDIM(arr));
    bool ok = std::fwrite(kMagic, 1, 6, f) == 6 &&
              std::fwrite(&mlen, 4, 1, f) == 1 &&
              std::fwrite(meta, 1, meta_len, f) == size_t(meta_len) &&
              std::fwrite(&ndim, 4, 1, f) == 1;
    for (uint32_t d = 0; ok && d < ndim; ++d) {
        uint64_t n = uint64_t(PyArray_DIM(arr, d));
        ok = std::fwrite(&n, 8, 1, f) == 1;
    }
    if (ok) {
        size_t n_vals = size_t(PyArray_SIZE(arr));
        ok = std::fwrite(PyArray_DATA(arr), 4, n_vals, f) == n_vals;
    }
    /* flush while we can still report it: fwrite success only means the
     * stdio buffer accepted the bytes — an ENOSPC at flush time would
     * otherwise vanish in FileCloser's destructor and leave a truncated
     * file behind a success return */
    ok = ok && std::fflush(f) == 0;
    Py_DECREF(arr);
    if (!ok) return PyErr_Format(PyExc_IOError, "short write to %s", path);
    Py_RETURN_NONE;
}

PyObject *read_packed(PyObject *, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;

    std::FILE *f = std::fopen(path, "rb");
    if (!f) return PyErr_Format(PyExc_FileNotFoundError, "%s", path);
    FileCloser closer{f};

    char magic[6];
    uint32_t mlen = 0, ndim = 0;
    if (std::fread(magic, 1, 6, f) != 6 || std::memcmp(magic, kMagic, 6) != 0)
        return PyErr_Format(PyExc_ValueError, "%s: not an XSTL1 file", path);
    if (std::fread(&mlen, 4, 1, f) != 1 || mlen > (1u << 20))
        return PyErr_Format(PyExc_ValueError, "%s: bad metadata length", path);

    std::vector<char> meta(mlen);
    if (mlen && std::fread(meta.data(), 1, mlen, f) != mlen)
        return PyErr_Format(PyExc_IOError, "%s: short read (meta)", path);
    if (std::fread(&ndim, 4, 1, f) != 1 || ndim == 0 || ndim > 8)
        return PyErr_Format(PyExc_ValueError, "%s: bad ndim", path);

    npy_intp dims[8];
    size_t n_vals = 1;
    for (uint32_t d = 0; d < ndim; ++d) {
        uint64_t n;
        if (std::fread(&n, 8, 1, f) != 1)
            return PyErr_Format(PyExc_IOError, "%s: short read (dims)", path);
        dims[d] = npy_intp(n);
        n_vals *= size_t(n);
    }

    PyObject *out = PyArray_SimpleNew(int(ndim), dims, NPY_FLOAT32);
    if (!out) return nullptr;
    if (std::fread(PyArray_DATA((PyArrayObject *)out), 4, n_vals, f) != n_vals) {
        Py_DECREF(out);
        return PyErr_Format(PyExc_IOError, "%s: short read (data)", path);
    }
    PyObject *meta_obj = PyBytes_FromStringAndSize(meta.data(), mlen);
    if (!meta_obj) { Py_DECREF(out); return nullptr; }
    return Py_BuildValue("NN", out, meta_obj);
}

PyMethodDef methods[] = {
    {"decode_cmod7", decode_cmod7, METH_VARARGS,
     "decode_cmod7(path) -> (51,250,73) f32 C-order (incidence, wspd, phi)"},
    {"write_packed", write_packed, METH_VARARGS,
     "write_packed(path, f32_array, meta_json_str)"},
    {"read_packed", read_packed, METH_VARARGS,
     "read_packed(path) -> (f32_array, meta_bytes)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "xsarsea_tpu_torch._lutio",
    "Native LUT codec (CMOD7 binary decode, packed LUT cache)",
    -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__lutio(void) {
    import_array();
    return PyModule_Create(&moduledef);
}
