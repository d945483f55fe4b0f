// The job's {blob_id: json_body} dict in one native pass.
//
// The egress of a batch job is a dict of about a million str -> str
// pairs: ids "user|timespan|z_r_c" and bodies '{"z_r_c": v.0, ...}'.
// This library writes every id and body straight into its own Python
// str and inserts the pairs into one dict, with no intermediate bytes,
// no split and no per-level dict.update:
//
//   (a) threads, GIL released: each blob's id length and maxchar, and
//       its body length;
//   (b) GIL held: one PyUnicode_New per id and per body;
//   (c) threads, GIL released: the characters, and each id's hash, into
//       strings that no Python code can see yet;
//   (d) GIL held: the pairs, in level order then blob order, into a dict
//       presized for the whole job (or into the dict the caller passes).
//
// The formatting is native/blobfmt.cpp's: integer digits, and "%lld.0"
// for the values, which the caller guarantees are integral doubles with
// |v| < 1e15 (then "%lld.0" is repr(float(v)), and "-0.0" is kept).
// Loaded with ctypes.PyDLL, so the call holds the GIL on entry.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// Per-level fields of the caller's int64 meta array, in this order.
enum Field {
  kEntries, kBlobs, kZoom, kCoarseZoom, kUserTable, kTsTable,
  kEntryWide, kIdxWide, kCoarseWide,
  kRows, kCols, kVals, kStarts, kUserIdx, kTsIdx, kCoarseRow, kCoarseCol,
  kFields
};

struct Level {
  int64_t n, n_blobs, zoom, coarse_zoom;
  int64_t user_table, ts_table;
  bool entry_wide, idx_wide, coarse_wide;
  const void *rows, *cols;
  const double* vals;
  const int64_t* starts;
  const void *user_idx, *ts_idx, *crow, *ccol;
  int64_t blob_base, entry_base;  // offsets into the job's sequences
};

struct Name {
  std::vector<uint32_t> cps;  // code points
  uint32_t maxchar = 0;
};

inline int64_t at(const void* p, bool wide, int64_t i) {
  return wide ? static_cast<const int64_t*>(p)[i]
              : static_cast<const int32_t*>(p)[i];
}

inline int ndigits(int64_t v) {
  uint64_t u = v < 0 ? 0 - static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
  int n = v < 0 ? 2 : 1;
  while (u >= 10) {
    u /= 10;
    ++n;
  }
  return n;
}

template <typename T>
inline T* put_i64(T* p, int64_t v) {
  uint64_t u = v < 0 ? 0 - static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
  if (v < 0) *p++ = '-';
  char tmp[24];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + u % 10);
    u /= 10;
  } while (u);
  while (n) *p++ = static_cast<T>(tmp[--n]);
  return p;
}

// A value's digits, sign included ("-0" for -0.0), before its ".0".
inline bool negative_zero(double v) { return v == 0.0 && std::signbit(v); }

inline int64_t value_len(double v) {
  return (negative_zero(v) ? 2 : ndigits(static_cast<int64_t>(v))) + 2;
}

struct Job {
  std::vector<Level> levels;
  std::vector<std::vector<Name>> tables;
  int64_t n_blobs = 0, n_entries = 0;
  // Per blob of the job: (a) fills the lengths and the id's maxchar,
  // (b) the strings, (c) their characters.
  std::vector<int64_t> id_len, body_len;
  std::vector<uint32_t> id_max;
  std::vector<PyObject*> ids, bodies;

  int64_t blob_end(const Level& L, int64_t b) const {
    return b + 1 < L.n_blobs ? L.starts[b + 1] : L.n;
  }

  // The job's blob whose first entry is the first at or after entry e.
  int64_t blob_at_entry(int64_t e) const {
    for (const Level& L : levels) {
      if (e < L.entry_base + L.n) {
        const int64_t* s = L.starts;
        int64_t k = std::lower_bound(s, s + L.n_blobs, e - L.entry_base) - s;
        return L.blob_base + k;
      }
    }
    return n_blobs;
  }

  // fn(level, local blob) over the job's blobs [g0, g1).
  template <typename Fn>
  void for_blobs(int64_t g0, int64_t g1, Fn fn) const {
    for (const Level& L : levels) {
      int64_t lo = std::max(g0, L.blob_base);
      int64_t hi = std::min(g1, L.blob_base + L.n_blobs);
      for (int64_t g = lo; g < hi; ++g) fn(L, g - L.blob_base);
    }
  }

  // n_threads + 1 cuts of the job's blobs, where the entries (the
  // bodies' work) divide evenly.
  std::vector<int64_t> cuts(int n_threads) const {
    std::vector<int64_t> cut{0};
    for (int t = 1; t < n_threads; ++t)
      cut.push_back(std::max(cut.back(),
                             blob_at_entry(n_entries * t / n_threads)));
    cut.push_back(n_blobs);
    return cut;
  }
};

// Run fn(g0, g1) on each slice between `cut`s, one thread a slice.
// `workers` is reserved by the caller, so nothing here allocates; a
// slice whose thread cannot start runs on the calling thread.
template <typename Fn>
void parallel(const std::vector<int64_t>& cut,
              std::vector<std::thread>& workers, Fn fn) {
  workers.clear();
  for (size_t t = 1; t + 1 < cut.size(); ++t) {
    try {
      workers.emplace_back(fn, cut[t], cut[t + 1]);
    } catch (const std::system_error&) {
      fn(cut[t], cut[t + 1]);
    }
  }
  fn(cut[0], cut[1]);
  for (auto& w : workers) w.join();
}

// Error codes of phase (a).
constexpr int kBadIndex = 1, kBadStarts = 2;

void measure(Job& job, int64_t g0, int64_t g1, std::atomic<int>* err) {
  job.for_blobs(g0, g1, [&](const Level& L, int64_t b) {
    const int64_t g = L.blob_base + b;
    const int64_t s = L.starts[b], e = job.blob_end(L, b);
    if (s < 0 || s >= e || e > L.n || (b == 0 && s != 0)) {
      err->store(kBadStarts);
      return;
    }
    const auto& users = job.tables[L.user_table];
    const auto& tss = job.tables[L.ts_table];
    const int64_t u = at(L.user_idx, L.idx_wide, s);
    const int64_t t = at(L.ts_idx, L.idx_wide, s);
    if (u < 0 || u >= static_cast<int64_t>(users.size()) || t < 0 ||
        t >= static_cast<int64_t>(tss.size())) {
      err->store(kBadIndex);
      return;
    }
    job.id_len[g] = static_cast<int64_t>(users[u].cps.size() +
                                         tss[t].cps.size()) +
                    2 + ndigits(L.coarse_zoom) + 1 +
                    ndigits(at(L.crow, L.coarse_wide, s)) + 1 +
                    ndigits(at(L.ccol, L.coarse_wide, s));
    job.id_max[g] = std::max(users[u].maxchar, tss[t].maxchar);
    // '{' + entries joined by ", " + '}'; an entry is
    // '"' z '_' r '_' c '": ' value '.0'.
    int64_t len = 2 + 2 * (e - s - 1);
    const int zl = ndigits(L.zoom);
    for (int64_t i = s; i < e; ++i)
      len += 1 + zl + 1 + ndigits(at(L.rows, L.entry_wide, i)) + 1 +
             ndigits(at(L.cols, L.entry_wide, i)) + 3 + value_len(L.vals[i]);
    job.body_len[g] = len;
  });
}

// A str's hash, as unicode_hash computes it (_Py_HashBytes over the
// data, length times kind), cached in the object by the thread that wrote
// it, so the dict insertion under the GIL does not read the id again.
// Elsewhere the dict computes it.
inline void set_hash(PyObject* s) {
#if PY_VERSION_HEX >= 0x030C0000 && PY_VERSION_HEX < 0x030E0000
  reinterpret_cast<PyASCIIObject*>(s)->hash = _Py_HashBytes(
      PyUnicode_DATA(s), PyUnicode_GET_LENGTH(s) * PyUnicode_KIND(s));
#else
  (void)s;
#endif
}

template <typename T>
void write_id(T* p, const Job& job, const Level& L, int64_t s) {
  const Name& user = job.tables[L.user_table][at(L.user_idx, L.idx_wide, s)];
  const Name& ts = job.tables[L.ts_table][at(L.ts_idx, L.idx_wide, s)];
  for (uint32_t c : user.cps) *p++ = static_cast<T>(c);
  *p++ = '|';
  for (uint32_t c : ts.cps) *p++ = static_cast<T>(c);
  *p++ = '|';
  p = put_i64(p, L.coarse_zoom);
  *p++ = '_';
  p = put_i64(p, at(L.crow, L.coarse_wide, s));
  *p++ = '_';
  put_i64(p, at(L.ccol, L.coarse_wide, s));
}

void write(const Job& job, int64_t g0, int64_t g1) {
  job.for_blobs(g0, g1, [&](const Level& L, int64_t b) {
    const int64_t g = L.blob_base + b;
    const int64_t s = L.starts[b], e = job.blob_end(L, b);
    PyObject* id = job.ids[g];
    switch (PyUnicode_KIND(id)) {
      case PyUnicode_1BYTE_KIND:
        write_id(PyUnicode_1BYTE_DATA(id), job, L, s);
        break;
      case PyUnicode_2BYTE_KIND:
        write_id(PyUnicode_2BYTE_DATA(id), job, L, s);
        break;
      default:
        write_id(PyUnicode_4BYTE_DATA(id), job, L, s);
    }
    set_hash(id);
    char* p = reinterpret_cast<char*>(PyUnicode_1BYTE_DATA(job.bodies[g]));
    *p++ = '{';
    for (int64_t i = s; i < e; ++i) {
      if (i > s) {
        *p++ = ',';
        *p++ = ' ';
      }
      *p++ = '"';
      p = put_i64(p, L.zoom);
      *p++ = '_';
      p = put_i64(p, at(L.rows, L.entry_wide, i));
      *p++ = '_';
      p = put_i64(p, at(L.cols, L.entry_wide, i));
      *p++ = '"';
      *p++ = ':';
      *p++ = ' ';
      const double v = L.vals[i];
      if (negative_zero(v)) {
        *p++ = '-';
        *p++ = '0';
      } else {
        p = put_i64(p, static_cast<int64_t>(v));
      }
      *p++ = '.';
      *p++ = '0';
    }
    *p = '}';
  });
}

// Read every name table (a list of lists of str) under the GIL.
bool read_tables(PyObject* tables, Job& job) {
  if (!PyList_Check(tables)) {
    PyErr_SetString(PyExc_TypeError, "name tables must be a list");
    return false;
  }
  const Py_ssize_t nt = PyList_GET_SIZE(tables);
  job.tables.resize(nt);
  for (Py_ssize_t k = 0; k < nt; ++k) {
    PyObject* names = PyList_GET_ITEM(tables, k);
    if (!PyList_Check(names)) {
      PyErr_SetString(PyExc_TypeError, "a name table must be a list of str");
      return false;
    }
    const Py_ssize_t nn = PyList_GET_SIZE(names);
    job.tables[k].resize(nn);
    for (Py_ssize_t j = 0; j < nn; ++j) {
      PyObject* s = PyList_GET_ITEM(names, j);
      if (!PyUnicode_Check(s)) {
        PyErr_SetString(PyExc_TypeError, "a name table must be a list of str");
        return false;
      }
      Name& name = job.tables[k][j];
      const int kind = PyUnicode_KIND(s);
      const void* data = PyUnicode_DATA(s);
      const Py_ssize_t len = PyUnicode_GET_LENGTH(s);
      name.cps.resize(len);
      for (Py_ssize_t i = 0; i < len; ++i) {
        name.cps[i] = PyUnicode_READ(kind, data, i);
        name.maxchar = std::max(name.maxchar, name.cps[i]);
      }
    }
  }
  return true;
}

bool read_levels(const int64_t* meta, int32_t n_levels, Job& job) {
  for (int32_t l = 0; l < n_levels; ++l) {
    const int64_t* m = meta + static_cast<int64_t>(l) * kFields;
    Level L;
    L.n = m[kEntries];
    L.n_blobs = m[kBlobs];
    L.zoom = m[kZoom];
    L.coarse_zoom = m[kCoarseZoom];
    L.user_table = m[kUserTable];
    L.ts_table = m[kTsTable];
    L.entry_wide = m[kEntryWide] != 0;
    L.idx_wide = m[kIdxWide] != 0;
    L.coarse_wide = m[kCoarseWide] != 0;
    L.rows = reinterpret_cast<const void*>(m[kRows]);
    L.cols = reinterpret_cast<const void*>(m[kCols]);
    L.vals = reinterpret_cast<const double*>(m[kVals]);
    L.starts = reinterpret_cast<const int64_t*>(m[kStarts]);
    L.user_idx = reinterpret_cast<const void*>(m[kUserIdx]);
    L.ts_idx = reinterpret_cast<const void*>(m[kTsIdx]);
    L.crow = reinterpret_cast<const void*>(m[kCoarseRow]);
    L.ccol = reinterpret_cast<const void*>(m[kCoarseCol]);
    const int64_t nt = static_cast<int64_t>(job.tables.size());
    if (L.n < 0 || L.n_blobs < 0 || L.n_blobs > L.n ||
        (L.n > 0) != (L.n_blobs > 0) || L.user_table < 0 ||
        L.user_table >= nt || L.ts_table < 0 || L.ts_table >= nt) {
      PyErr_SetString(PyExc_ValueError, "blob dict: malformed level");
      return false;
    }
    if (L.n == 0) continue;
    L.blob_base = job.n_blobs;
    L.entry_base = job.n_entries;
    job.n_blobs += L.n_blobs;
    job.n_entries += L.n;
    job.levels.push_back(L);
  }
  return true;
}

void release(std::vector<PyObject*>& objs) {
  for (PyObject*& o : objs) Py_CLEAR(o);
}

PyObject* build(const int64_t* meta, int32_t n_levels, PyObject* tables,
                PyObject* out, int32_t n_threads) {
  Job job;
  if (!read_tables(tables, job) || !read_levels(meta, n_levels, job))
    return nullptr;
  if (out != Py_None && !PyDict_Check(out)) {
    PyErr_SetString(PyExc_TypeError, "out must be a dict or None");
    return nullptr;
  }
  const int64_t B = job.n_blobs;
  job.id_len.assign(B, 0);
  job.body_len.assign(B, 0);
  job.id_max.assign(B, 0);
  job.ids.assign(B, nullptr);
  job.bodies.assign(B, nullptr);
  const int threads = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(std::max(n_threads, 1), B)));
  const std::vector<int64_t> cut = job.cuts(threads);
  std::vector<std::thread> workers;
  workers.reserve(threads);

  // (a) lengths, without the GIL.
  std::atomic<int> err{0};
  Py_BEGIN_ALLOW_THREADS
  parallel(cut, workers, [&](int64_t g0, int64_t g1) {
    measure(job, g0, g1, &err);
  });
  Py_END_ALLOW_THREADS
  if (err.load() == kBadIndex) {
    PyErr_SetString(PyExc_ValueError,
                    "blob-id dictionary index out of range for its name table");
    return nullptr;
  }
  if (err.load() == kBadStarts) {
    PyErr_SetString(PyExc_ValueError,
                    "blob starts must rise from 0 inside their level");
    return nullptr;
  }

  // (b) the strings, under the GIL.
  for (int64_t g = 0; g < B; ++g) {
    job.ids[g] = PyUnicode_New(job.id_len[g], job.id_max[g]);
    job.bodies[g] = job.ids[g] ? PyUnicode_New(job.body_len[g], 127) : nullptr;
    if (job.bodies[g] == nullptr) {
      release(job.ids);
      release(job.bodies);
      return nullptr;  // PyUnicode_New set MemoryError
    }
  }

  // (c) their characters, without the GIL.
  Py_BEGIN_ALLOW_THREADS
  parallel(cut, workers,
           [&](int64_t g0, int64_t g1) { write(job, g0, g1); });
  Py_END_ALLOW_THREADS

  // (d) the dict, under the GIL.
  PyObject* dict;
  if (out == Py_None) {
#if PY_VERSION_HEX < 0x030D0000
    dict = _PyDict_NewPresized(B);
#else
    dict = PyDict_New();
#endif
  } else {
    dict = Py_NewRef(out);
  }
  if (dict == nullptr) {
    release(job.ids);
    release(job.bodies);
    return nullptr;
  }
  // The insertion touches each id's and body's header, written long
  // before on another core: fetch them a few blobs ahead.
  constexpr int64_t kAhead = 8;
  for (int64_t g = 0; g < B; ++g) {
    if (g + kAhead < B) {
      __builtin_prefetch(job.ids[g + kAhead], 1);
      __builtin_prefetch(job.bodies[g + kAhead], 1);
    }
    if (PyDict_SetItem(dict, job.ids[g], job.bodies[g]) < 0) {
      release(job.ids);
      release(job.bodies);
      Py_DECREF(dict);
      return nullptr;
    }
    Py_CLEAR(job.ids[g]);
    Py_CLEAR(job.bodies[g]);
  }
  return dict;
}

}  // namespace

extern "C" {

// The {blob_id: json_body} dict of n_levels sorted levels (meta: kFields
// int64 a level, see Field), or a new reference to `out` with the pairs
// inserted when `out` is a dict. `tables` is a list of lists of str, the
// name tables the levels' user_table and ts_table fields index. Returns
// NULL with an exception set (ValueError for a bad index or start,
// MemoryError, TypeError), having released every object it made.
PyObject* hm_blob_dict(const int64_t* meta, int32_t n_levels,
                       PyObject* tables, PyObject* out, int32_t n_threads) {
  try {
    return build(meta, n_levels, tables, out, n_threads);
  } catch (const std::bad_alloc&) {
    return PyErr_NoMemory();
  }
}

}  // extern "C"
