// fastfeat: native host-side text featurization for the feed (a copy of
// laff_tpu/native/fastfeat.cpp).
//
// The data feed tokenizes and featurizes every caption on the host
// (BoW counts, GRU index streams). This extension runs that pipeline
// (ASCII clean -> lowercase split -> stopword filter -> vocab lookup ->
// scatter) in C++ with PyDict lookups, writing straight into
// caller-provided numpy buffers. Semantics are identical to
// laff_tpu_torch.text (TextTool.tokenize with clean=True,
// remove_stopword per featurizer): tests/test_torch_port_native.py holds
// its arrays equal to the Python path's and laff_tpu's. chip_smoke.py's
// featurizer_timing measured no gain from it on a full-width validation
// set's text pass (embed_txt, and a validation that stages): the w2v
// mean and the dense bow rows, which stay in Python and numpy, hold that
// pass (PERF.md, Findings and Open questions).
//
// Exposed functions (all fill preallocated buffers):
//   encode_bow(captions, word2idx, stopwords|None, out_f32[B, V])
//   encode_idx(captions, word2idx, unk, start, end,
//              out_ids_i32[B, T], out_len_i32[B])

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <string>
#include <vector>

namespace {

// tokenize: non-alphanumeric -> space, lowercase, split.
// Mirrors re.sub(r"[^A-Za-z0-9]", " ", s).strip().lower().split().
// Multi-byte UTF-8 bytes are non-ASCII-alphanumeric, so each byte maps to
// a separator — the regex treats non-ASCII chars the same way.
std::vector<std::string> tokenize(const char* text, Py_ssize_t len) {
  std::vector<std::string> tokens;
  std::string current;
  current.reserve(16);
  for (Py_ssize_t i = 0; i < len; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if ((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9')) {
      current.push_back(static_cast<char>(c));
    } else if (c >= 'A' && c <= 'Z') {
      current.push_back(static_cast<char>(c - 'A' + 'a'));
    } else {
      if (!current.empty()) {
        tokens.push_back(std::move(current));
        current.clear();
      }
    }
  }
  if (!current.empty()) tokens.push_back(std::move(current));
  return tokens;
}

// Look a token up in a PyDict via a cheap interned temporary.
inline PyObject* dict_get(PyObject* dict, const std::string& token) {
  PyObject* key = PyUnicode_FromStringAndSize(token.data(),
                                              (Py_ssize_t)token.size());
  if (key == nullptr) return nullptr;
  PyObject* value = PyDict_GetItem(dict, key);  // borrowed
  Py_DECREF(key);
  return value;
}

inline bool in_set(PyObject* set_or_none, const std::string& token) {
  if (set_or_none == Py_None) return false;
  PyObject* key = PyUnicode_FromStringAndSize(token.data(),
                                              (Py_ssize_t)token.size());
  if (key == nullptr) return false;
  int hit = PySet_Contains(set_or_none, key);
  Py_DECREF(key);
  return hit == 1;
}

// encode_bow(captions, word2idx, stopwords|None, out) -> None
PyObject* encode_bow(PyObject*, PyObject* args) {
  PyObject *captions, *word2idx, *stopwords, *out;
  if (!PyArg_ParseTuple(args, "OOOO", &captions, &word2idx, &stopwords, &out)) {
    return nullptr;
  }
  Py_buffer view;
  if (PyObject_GetBuffer(out, &view, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS |
                                          PyBUF_FORMAT) < 0) {
    return nullptr;
  }
  if (view.ndim != 2 || view.itemsize != 4) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "out must be a C-contiguous (B, V) float32 array");
    return nullptr;
  }
  Py_ssize_t batch = view.shape[0];
  Py_ssize_t vdim = view.shape[1];
  float* data = static_cast<float*>(view.buf);
  memset(data, 0, (size_t)batch * (size_t)vdim * sizeof(float));

  Py_ssize_t n = PySequence_Size(captions);
  if (n != batch) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "len(captions) != out.shape[0]");
    return nullptr;
  }
  for (Py_ssize_t b = 0; b < n; ++b) {
    PyObject* cap = PySequence_GetItem(captions, b);  // new ref
    if (cap == nullptr) { PyBuffer_Release(&view); return nullptr; }
    Py_ssize_t len = 0;
    const char* text = PyUnicode_AsUTF8AndSize(cap, &len);
    if (text == nullptr) { Py_DECREF(cap); PyBuffer_Release(&view); return nullptr; }
    for (const auto& token : tokenize(text, len)) {
      if (in_set(stopwords, token)) continue;
      PyObject* idx = dict_get(word2idx, token);
      if (idx != nullptr) {
        long i = PyLong_AsLong(idx);
        if (i >= 0 && i < vdim) data[b * vdim + i] += 1.0f;
      }
    }
    Py_DECREF(cap);
  }
  PyBuffer_Release(&view);
  Py_RETURN_NONE;
}

// encode_idx(captions, word2idx, unk, start, end, out_ids, out_len) -> None
PyObject* encode_idx(PyObject*, PyObject* args) {
  PyObject *captions, *word2idx, *out_ids, *out_len;
  long unk, start, end;
  if (!PyArg_ParseTuple(args, "OOlllOO", &captions, &word2idx, &unk, &start,
                        &end, &out_ids, &out_len)) {
    return nullptr;
  }
  Py_buffer ids_view, len_view;
  if (PyObject_GetBuffer(out_ids, &ids_view,
                         PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0) {
    return nullptr;
  }
  if (PyObject_GetBuffer(out_len, &len_view,
                         PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) < 0) {
    PyBuffer_Release(&ids_view);
    return nullptr;
  }
  Py_ssize_t batch = ids_view.shape[0];
  Py_ssize_t max_len = ids_view.shape[1];
  int32_t* ids = static_cast<int32_t*>(ids_view.buf);
  int32_t* lens = static_cast<int32_t*>(len_view.buf);
  memset(ids, 0, (size_t)batch * (size_t)max_len * sizeof(int32_t));

  Py_ssize_t n = PySequence_Size(captions);
  for (Py_ssize_t b = 0; b < n && b < batch; ++b) {
    PyObject* cap = PySequence_GetItem(captions, b);
    if (cap == nullptr) goto fail;
    {
      Py_ssize_t len = 0;
      const char* text = PyUnicode_AsUTF8AndSize(cap, &len);
      if (text == nullptr) { Py_DECREF(cap); goto fail; }
      std::vector<long> seq;
      seq.push_back(start);
      for (const auto& token : tokenize(text, len)) {
        PyObject* idx = dict_get(word2idx, token);
        seq.push_back(idx != nullptr ? PyLong_AsLong(idx) : unk);
      }
      seq.push_back(end);
      Py_ssize_t t = (Py_ssize_t)seq.size();
      if (t > max_len) { t = max_len; }
      for (Py_ssize_t k = 0; k < t; ++k) {
        ids[b * max_len + k] = (int32_t)seq[k];
      }
      lens[b] = (int32_t)t;
    }
    Py_DECREF(cap);
  }
  PyBuffer_Release(&ids_view);
  PyBuffer_Release(&len_view);
  Py_RETURN_NONE;
fail:
  PyBuffer_Release(&ids_view);
  PyBuffer_Release(&len_view);
  return nullptr;
}

PyMethodDef kMethods[] = {
    {"encode_bow", encode_bow, METH_VARARGS,
     "Batched bag-of-words counting into a float32 buffer."},
    {"encode_idx", encode_idx, METH_VARARGS,
     "Batched <start> w.. <end> index encoding into int32 buffers."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "fastfeat",
    "Native host-side text featurization.", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit_fastfeat(void) { return PyModule_Create(&kModule); }
