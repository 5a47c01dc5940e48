// Native runtime components for openfdcm_tpu.
//
// The reference implements its entire runtime in C++ (header-only library +
// pybind11 bindings).  This port keeps the compute path in XLA, but the
// host-side runtime pieces that the reference implements natively are native
// here too:
//
//   * the binary line-file codec (reference core/serialization.h:42-150 +
//     the packio zlib envelope) — parse/serialize + zlib inflate/deflate,
//   * a multi-threaded batch file loader (the data-loading analogue of the
//     reference's BS::thread_pool fan-outs),
//   * DefaultSearch pair generation (reference
//     src/searchstrategies/defaultsearch.cpp:29-49 — argsort by length,
//     closest-length binary search, centered window).
//
// Exposed as the CPython extension module `openfdcm_tpu._native` (no
// pybind11 in this environment; plain CPython C API).  openfdcm_tpu's
// Python wrappers fall back to pure-Python implementations when the
// extension is not built.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <numeric>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr char kSignature[8] = {'O', 'P', 'E', 'N', 'F', 'D', 'C', 'M'};
constexpr size_t kHeaderSize = 45;   // packed LinesSerialHeader
constexpr size_t kEnvelopeSize = 16 + 2 + 4 + 1 + 8 + 8;

template <typename T>
void put_le(std::string& out, T v) {
    unsigned char buf[sizeof(T)];
    std::memcpy(buf, &v, sizeof(T));  // x86: already little-endian
    out.append(reinterpret_cast<char*>(buf), sizeof(T));
}

template <typename T>
T get_le(const unsigned char* p) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    return v;
}

// ---------------------------------------------------------------------------
// Codec
// ---------------------------------------------------------------------------

std::string serialize_body(const float* data, uint64_t n_lines,
                           uint16_t yday, uint16_t year) {
    std::string body;
    body.reserve(kHeaderSize + n_lines * 16);
    put_le<uint16_t>(body, 0);
    put_le<uint32_t>(body, 0);
    put_le<uint16_t>(body, 0);
    put_le<uint16_t>(body, 0);
    body.append(8, '\0');
    put_le<uint16_t>(body, 0);   // version major
    put_le<uint16_t>(body, 8);   // version minor
    put_le<uint16_t>(body, 0);   // version patch
    put_le<uint16_t>(body, yday);
    put_le<uint16_t>(body, year);
    put_le<uint16_t>(body, static_cast<uint16_t>(kHeaderSize));
    put_le<uint32_t>(body, static_cast<uint32_t>(kHeaderSize));
    body.push_back('\0');        // line data format = 0
    put_le<uint16_t>(body, 16);  // record length (4 x f32)
    put_le<uint64_t>(body, n_lines);
    body.append(reinterpret_cast<const char*>(data), n_lines * 16);
    return body;
}

std::string envelope(const std::string& body, bool compress) {
    std::string out;
    out.append(kSignature, 8);
    out.append(8, '\0');
    put_le<uint16_t>(out, 0);
    put_le<uint32_t>(out, 2);
    if (compress) {
        uLongf bound = compressBound(body.size());
        std::string comp(bound, '\0');
        if (compress2(reinterpret_cast<Bytef*>(comp.data()), &bound,
                      reinterpret_cast<const Bytef*>(body.data()), body.size(),
                      Z_DEFAULT_COMPRESSION) != Z_OK)
            throw std::runtime_error("zlib compression failed");
        comp.resize(bound);
        out.push_back('\x01');
        put_le<uint64_t>(out, body.size());
        put_le<uint64_t>(out, comp.size());
        out += comp;
    } else {
        out.push_back('\0');
        put_le<uint64_t>(out, body.size());
        put_le<uint64_t>(out, body.size());
        out += body;
    }
    return out;
}

// Parse a whole line file; returns the raw float payload.
std::string parse_lines(const unsigned char* data, size_t size,
                        uint64_t* n_out) {
    if (size < kEnvelopeSize || std::memcmp(data, kSignature, 8) != 0)
        throw std::runtime_error("not an OPENFDCM line file (bad signature)");
    const unsigned char flag = data[22];
    const uint64_t usz = get_le<uint64_t>(data + 23);
    const uint64_t csz = get_le<uint64_t>(data + 31);
    // Overflow-safe: size >= kEnvelopeSize was checked above, so compare
    // csz against the remaining bytes instead of forming kEnvelopeSize+csz
    // (which wraps for crafted csz near 2^64).
    if (csz > size - kEnvelopeSize)
        throw std::runtime_error("corrupt line file (truncated)");
    // Cap the declared uncompressed size before allocating: a legitimate
    // line file body is kHeaderSize + n*record bytes; 1 GiB covers ~64M
    // lines and keeps a crafted usz from triggering a giant allocation.
    if (usz > (1ull << 30))
        throw std::runtime_error("corrupt line file (unreasonable size)");
    std::string body;
    if (flag) {
        body.resize(usz);
        uLongf dlen = usz;
        if (uncompress(reinterpret_cast<Bytef*>(body.data()), &dlen,
                       data + kEnvelopeSize, csz) != Z_OK || dlen != usz)
            throw std::runtime_error("corrupt line file (zlib)");
    } else {
        body.assign(reinterpret_cast<const char*>(data + kEnvelopeSize), csz);
    }
    if (body.size() < kHeaderSize)
        throw std::runtime_error("corrupt line file (short body)");
    const auto* b = reinterpret_cast<const unsigned char*>(body.data());
    const unsigned char line_format = b[34];
    const uint16_t record_len = get_le<uint16_t>(b + 35);
    const uint64_t n = get_le<uint64_t>(b + 37);
    if (line_format != 0)
        throw std::runtime_error("Line data format not recognized");
    if (body.size() < kHeaderSize + n * record_len)
        throw std::runtime_error("corrupt line file (short payload)");
    *n_out = n;
    return body.substr(kHeaderSize, n * record_len);
}

std::string read_file(const std::string& path) {
    std::ifstream f(path, std::ios::binary);
    if (!f) throw std::runtime_error("cannot open file: " + path);
    return std::string(std::istreambuf_iterator<char>(f),
                       std::istreambuf_iterator<char>());
}

// ---------------------------------------------------------------------------
// Python bindings
// ---------------------------------------------------------------------------

PyObject* py_loads(PyObject*, PyObject* args) {
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
    uint64_t n = 0;
    std::string payload;
    try {
        payload = parse_lines(static_cast<const unsigned char*>(buf.buf),
                              buf.len, &n);
    } catch (const std::exception& e) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, e.what());
        return nullptr;
    }
    PyBuffer_Release(&buf);
    PyObject* bytes = PyBytes_FromStringAndSize(payload.data(), payload.size());
    if (!bytes) return nullptr;
    return Py_BuildValue("(NK)", bytes, static_cast<unsigned long long>(n));
}

PyObject* py_dumps(PyObject*, PyObject* args) {
    Py_buffer buf;
    int compress = 1;
    int yday = 0, year = 0;
    if (!PyArg_ParseTuple(args, "y*|pii", &buf, &compress, &yday, &year))
        return nullptr;
    if (buf.len % 16 != 0) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "payload must be N*16 bytes (4 x f32 per line)");
        return nullptr;
    }
    std::string out;
    try {
        std::string body = serialize_body(static_cast<const float*>(buf.buf),
                                          buf.len / 16,
                                          static_cast<uint16_t>(yday),
                                          static_cast<uint16_t>(year));
        out = envelope(body, compress != 0);
    } catch (const std::exception& e) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, e.what());
        return nullptr;
    }
    PyBuffer_Release(&buf);
    return PyBytes_FromStringAndSize(out.data(), out.size());
}

PyObject* py_read_file(PyObject*, PyObject* args) {
    const char* path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
    uint64_t n = 0;
    std::string payload;
    Py_BEGIN_ALLOW_THREADS
    try {
        std::string raw = read_file(path);
        payload = parse_lines(reinterpret_cast<const unsigned char*>(raw.data()),
                              raw.size(), &n);
    } catch (...) {
        payload.clear();
        n = UINT64_MAX;
    }
    Py_END_ALLOW_THREADS
    if (n == UINT64_MAX) {
        PyErr_Format(PyExc_ValueError, "failed to read line file: %s", path);
        return nullptr;
    }
    PyObject* bytes = PyBytes_FromStringAndSize(payload.data(), payload.size());
    if (!bytes) return nullptr;
    return Py_BuildValue("(NK)", bytes, static_cast<unsigned long long>(n));
}

PyObject* py_read_batch(PyObject*, PyObject* args) {
    PyObject* list;
    int num_threads = 0;
    if (!PyArg_ParseTuple(args, "O|i", &list, &num_threads)) return nullptr;
    PyObject* seq = PySequence_Fast(list, "expected a sequence of paths");
    if (!seq) return nullptr;
    Py_ssize_t n_files = PySequence_Fast_GET_SIZE(seq);
    std::vector<std::string> paths(n_files);
    for (Py_ssize_t i = 0; i < n_files; ++i) {
        PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
        const char* s = PyUnicode_AsUTF8(item);
        if (!s) { Py_DECREF(seq); return nullptr; }
        paths[i] = s;
    }
    Py_DECREF(seq);

    std::vector<std::string> payloads(n_files);
    std::vector<uint64_t> counts(n_files, UINT64_MAX);
    if (num_threads <= 0)
        num_threads = std::max(1u, std::thread::hardware_concurrency());
    num_threads = std::min<long>(num_threads, std::max<long>(1, n_files));

    Py_BEGIN_ALLOW_THREADS
    {
        std::vector<std::thread> workers;
        std::atomic_long next{0};
        static_assert(sizeof(long) >= sizeof(Py_ssize_t) || true, "");
        for (int t = 0; t < num_threads; ++t) {
            workers.emplace_back([&]() {
                while (true) {
                    long i = next.fetch_add(1);
                    if (i >= n_files) break;
                    try {
                        std::string raw = read_file(paths[i]);
                        uint64_t n = 0;
                        payloads[i] = parse_lines(
                            reinterpret_cast<const unsigned char*>(raw.data()),
                            raw.size(), &n);
                        counts[i] = n;
                    } catch (...) {
                        counts[i] = UINT64_MAX;
                    }
                }
            });
        }
        for (auto& w : workers) w.join();
    }
    Py_END_ALLOW_THREADS

    PyObject* out = PyList_New(n_files);
    if (!out) return nullptr;
    for (Py_ssize_t i = 0; i < n_files; ++i) {
        if (counts[i] == UINT64_MAX) {
            Py_DECREF(out);
            PyErr_Format(PyExc_ValueError, "failed to read line file: %s",
                         paths[i].c_str());
            return nullptr;
        }
        PyObject* bytes = PyBytes_FromStringAndSize(payloads[i].data(),
                                                    payloads[i].size());
        if (!bytes) { Py_DECREF(out); return nullptr; }
        PyObject* tup = Py_BuildValue("(NK)", bytes,
                                      static_cast<unsigned long long>(counts[i]));
        if (!tup) { Py_DECREF(out); Py_DECREF(bytes); return nullptr; }
        PyList_SET_ITEM(out, i, tup);
    }
    return out;
}

// DefaultSearch pair generation: argsort by length (descending, stable),
// closest-length binary search, centered window.  Mirrors
// reference src/searchstrategies/defaultsearch.cpp:29-49 and the Python
// port in openfdcm_tpu/matching/search.py.
PyObject* py_default_search_pairs(PyObject*, PyObject* args) {
    Py_buffer tbuf, sbuf;
    long max_tmpl, max_scene;
    if (!PyArg_ParseTuple(args, "y*y*ll", &tbuf, &sbuf, &max_tmpl, &max_scene))
        return nullptr;
    const float* tl = static_cast<const float*>(tbuf.buf);
    const float* sl = static_cast<const float*>(sbuf.buf);
    const long nt = tbuf.len / 4;
    const long ns = sbuf.len / 4;

    std::vector<int32_t> out;
    try {
        std::vector<long> order_t(nt), order_s(ns);
        std::iota(order_t.begin(), order_t.end(), 0);
        std::iota(order_s.begin(), order_s.end(), 0);
        std::stable_sort(order_t.begin(), order_t.end(),
                         [&](long a, long b) { return tl[a] > tl[b]; });
        std::stable_sort(order_s.begin(), order_s.end(),
                         [&](long a, long b) { return sl[a] > sl[b]; });
        std::vector<float> sorted_s(ns);
        for (long i = 0; i < ns; ++i) sorted_s[i] = sl[order_s[i]];

        const long t_count = std::min(nt, max_tmpl);
        out.reserve(t_count * std::min(ns, max_scene) * 2);
        for (long ti = 0; ti < t_count; ++ti) {
            const long t = order_t[ti];
            const float value = tl[t];
            // searchsorted(-sorted, -value, 'left'): first index with
            // sorted[i] <= value.
            long lo = 0, hi = ns;
            while (lo < hi) {
                long mid = (lo + hi) / 2;
                if (sorted_s[mid] > value) lo = mid + 1; else hi = mid;
            }
            long c;
            if (lo == 0) c = 0;
            else if (lo == ns) c = ns - 1;
            else c = (std::abs(value - sorted_s[lo])
                      < std::abs(value - sorted_s[lo - 1])) ? lo : lo - 1;
            long begin = std::max(0L, c - max_scene / 2);
            long end = std::min(begin + max_scene, ns);
            begin = std::max(0L, end - max_scene);
            for (long i = begin; i < end; ++i) {
                out.push_back(static_cast<int32_t>(t));
                out.push_back(static_cast<int32_t>(order_s[i]));
            }
        }
    } catch (const std::bad_alloc&) {
        PyBuffer_Release(&tbuf);
        PyBuffer_Release(&sbuf);
        PyErr_SetString(PyExc_MemoryError, "default_search_pairs: allocation failed");
        return nullptr;
    } catch (const std::exception& e) {
        PyBuffer_Release(&tbuf);
        PyBuffer_Release(&sbuf);
        PyErr_SetString(PyExc_ValueError, e.what());
        return nullptr;
    }
    PyBuffer_Release(&tbuf);
    PyBuffer_Release(&sbuf);
    return PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(out.data()), out.size() * sizeof(int32_t));
}

PyMethodDef methods[] = {
    {"loads", py_loads, METH_VARARGS,
     "loads(data) -> (payload_bytes, n_lines): parse an OPENFDCM line buffer"},
    {"dumps", py_dumps, METH_VARARGS,
     "dumps(payload, compress=True, yday=0, year=0) -> bytes"},
    {"read_file", py_read_file, METH_VARARGS,
     "read_file(path) -> (payload_bytes, n_lines)"},
    {"read_batch", py_read_batch, METH_VARARGS,
     "read_batch(paths, num_threads=0) -> list[(payload_bytes, n_lines)]"},
    {"default_search_pairs", py_default_search_pairs, METH_VARARGS,
     "default_search_pairs(tmpl_lengths_f32, scene_lengths_f32, max_tmpl, "
     "max_scene) -> int32 pairs bytes"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native",
    "Native runtime components (line-file codec, batch loader, search pairs)",
    -1, methods,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__native(void) {
    return PyModule_Create(&moduledef);
}
