/* Native runtime kernels for hhsuite_tpu (CPython extension).
 *
 * TPU-native equivalent of the reference's C storage layer: the
 * ffindex index parser (lib/ffindex/src/ffindex.c:ffindex_index_parse)
 * and the ca3m record decoder (src/a3m_compress.cpp:245-354) are the
 * host-side hot loops when streaming large template databases; both
 * are reimplemented here and loaded by io/ffindex.py and io/ca3m.py
 * when built (hhsuite_tpu_torch.native.build()), with pure-Python
 * fallbacks otherwise.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

/* parse_index(data: bytes) -> list[(name, offset, length)]
 * Text lines "name\toffset\tlength\n". */
static PyObject *parse_index(PyObject *, PyObject *args) {
  const char *buf;
  Py_ssize_t n;
  if (!PyArg_ParseTuple(args, "y#", &buf, &n)) return nullptr;
  PyObject *out = PyList_New(0);
  if (!out) return nullptr;
  const char *p = buf;
  const char *end = buf + n;
  while (p < end) {
    const char *nl = static_cast<const char *>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    const char *line_end = nl ? nl : end;
    const char *t1 = static_cast<const char *>(
        memchr(p, '\t', static_cast<size_t>(line_end - p)));
    if (t1) {
      const char *t2 = static_cast<const char *>(
          memchr(t1 + 1, '\t', static_cast<size_t>(line_end - t1 - 1)));
      if (t2) {
        long long off = strtoll(t1 + 1, nullptr, 10);
        long long len = strtoll(t2 + 1, nullptr, 10);
        PyObject *tup = Py_BuildValue(
            "(s#LL)", p, static_cast<Py_ssize_t>(t1 - p), off, len);
        if (!tup || PyList_Append(out, tup) < 0) {
          Py_XDECREF(tup);
          Py_DECREF(out);
          return nullptr;
        }
        Py_DECREF(tup);
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  return out;
}

/* iter_ca3m_records(data: bytes, offset: int)
 *   -> list[(entry_index, start_pos, blocks_bytes)] */
static PyObject *iter_ca3m_records(PyObject *, PyObject *args) {
  const unsigned char *buf;
  Py_ssize_t n;
  Py_ssize_t pos;
  if (!PyArg_ParseTuple(args, "y#n", &buf, &n, &pos)) return nullptr;
  PyObject *out = PyList_New(0);
  if (!out) return nullptr;
  while (pos + 8 <= n) {
    uint32_t entry_index;
    uint16_t start_pos, nr_blocks;
    memcpy(&entry_index, buf + pos, 4);
    memcpy(&start_pos, buf + pos + 4, 2);
    memcpy(&nr_blocks, buf + pos + 6, 2);
    pos += 8;
    Py_ssize_t blk_bytes = static_cast<Py_ssize_t>(nr_blocks) * 2;
    if (pos + blk_bytes > n) break;
    PyObject *tup = Py_BuildValue(
        "(IHy#)", entry_index, start_pos,
        reinterpret_cast<const char *>(buf + pos), blk_bytes);
    pos += blk_bytes;
    if (!tup || PyList_Append(out, tup) < 0) {
      Py_XDECREF(tup);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(tup);
  }
  return out;
}

/* expand_ca3m_record(start_pos, blocks: bytes, full_seq: bytes,
 *                    consensus_length) -> bytes (a3m row) */
static PyObject *expand_ca3m_record(PyObject *, PyObject *args) {
  Py_ssize_t start_pos, cons_len;
  const unsigned char *blocks;
  Py_ssize_t nblk_bytes;
  const unsigned char *full;
  Py_ssize_t full_len;
  if (!PyArg_ParseTuple(args, "ny#y#n", &start_pos, &blocks, &nblk_bytes,
                        &full, &full_len, &cons_len))
    return nullptr;
  std::string out;
  out.reserve(static_cast<size_t>(cons_len) + 64);
  Py_ssize_t actual = start_pos;
  Py_ssize_t aln_len = 0;
  for (Py_ssize_t b = 0; b + 1 < nblk_bytes; b += 2) {
    unsigned int nr_matches = blocks[b];
    int ins_del = static_cast<int8_t>(blocks[b + 1]);
    for (unsigned int i = 0; i < nr_matches; i++) {
      if (actual - 1 < 0 || actual - 1 >= full_len) {
        PyErr_SetString(PyExc_ValueError,
                        "ca3m record points outside full sequence");
        return nullptr;
      }
      out.push_back(static_cast<char>(full[actual - 1]));
      actual++;
      aln_len++;
    }
    if (ins_del > 0) {
      for (int i = 0; i < ins_del; i++) {
        if (actual - 1 < 0 || actual - 1 >= full_len) {
          PyErr_SetString(PyExc_ValueError,
                          "ca3m record points outside full sequence");
          return nullptr;
        }
        out.push_back(static_cast<char>(
            tolower(full[actual - 1])));
        actual++;
      }
    } else {
      for (int i = 0; i < -ins_del; i++) {
        out.push_back('-');
        aln_len++;
      }
    }
  }
  while (aln_len < cons_len) {
    out.push_back('-');
    aln_len++;
  }
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

/* ---------------------------------------------------------------------
 * Posterior decoder hot loops (Forward/Backward/MAC), bit-identical to
 * search/posterior.py's _forward/_backward/_mac (which in turn mirror
 * src/hhforwardalgorithm.cpp / hhbackwardalgorithm.cpp /
 * hhmacalgorithm.cpp): double-precision row-rescaled F/B over a
 * cell-off corridor, float32 fast-math helpers, float32 MAC DP.
 * ------------------------------------------------------------------- */

static inline float fpow2f(float x) {
  /* util-inl.h:190-215 truncation trick + poly4 (see fastmath.fpow2) */
  float tx = (x - 0.5f) + (float)(3 << 22);
  int32_t lx;
  memcpy(&lx, &tx, 4);
  lx -= 0x4B400000;
  float dx = x - (float)lx;
  float p = 0.0134929f;
  p = dx * p + 0.0520749f;
  p = dx * p + 0.241404f;
  p = dx * p + 0.693019f;
  float r = dx * p + 1.0f;
  int32_t bits;
  memcpy(&bits, &r, 4);
  bits += (lx << 23);
  memcpy(&r, &bits, 4);
  if (x >= 128.0f) r = 3.402823466e+38f;
  if (x <= -125.0f) r = 0.0f;
  return r;
}

static inline float sp20(const float *a, const float *b) {
  /* hhhit-inl.h:62-120 SSE summation tree (see fastmath.scalar_prod20) */
  float p[20];
  for (int l = 0; l < 20; l++) p[l] = a[l] * b[l];
  float lanes[4];
  for (int l = 0; l < 4; l++)
    lanes[l] = ((p[l] + p[l + 4]) + (p[l + 8] + p[l + 12])) + p[l + 16];
  return (lanes[3] + lanes[2]) + (lanes[1] + lanes[0]);
}

enum { T_M2M = 0, T_M2I = 1, T_M2D = 2, T_I2M = 3, T_I2I = 4,
       T_D2M = 5, T_D2D = 6 };
enum { S_STOP = 0, S_MM = 2, S_GD = 3, S_IM = 4, S_DG = 5, S_MI = 6 };

struct Arr2f {
  const float *d;
  Py_ssize_t cols;
  const float *row(Py_ssize_t i) const { return d + i * cols; }
};
struct Arr2d {
  const double *d;
  Py_ssize_t cols;
  const double *row(Py_ssize_t i) const { return d + i * cols; }
};

/* posterior_fb_mac(qp, tp, qtr, ttr, co, ss, p_mm, scale, bmac,
 *                  shift, local, mact)
 *   qp (Lq+2,20) f32 C; tp (Lt+2,20) f32 C; qtr/(Lq+?,7) f64; ttr f64;
 *   co (Lq+1,Lt+1) uint8; ss (Lq+2,Lt+2) f32 (zeros when no SS);
 *   p_mm (Lq+1,Lt+1) f64 out; scale (Lq+2) f64 out;
 *   bmac (Lq+1,Lt+1) uint8 out.
 * Returns (Pforward, score, fwd_triples, bwd_triples, i2, j2).
 */
static PyObject *posterior_fb_mac(PyObject *, PyObject *args) {
  Py_buffer qp_b, tp_b, qtr_b, ttr_b, co_b, ss_b, pmm_b, sc_b, bm_b;
  double shift, mact;
  int local;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*w*w*w*did", &qp_b, &tp_b,
                        &qtr_b, &ttr_b, &co_b, &ss_b, &pmm_b, &sc_b,
                        &bm_b, &shift, &local, &mact))
    return nullptr;

  Py_ssize_t Lt1 = 0;  /* columns of p_mm = Lt+1 */
  PyObject *ret = nullptr;
  {
    /* geometry from buffer sizes */
    Py_ssize_t Lq2 = qp_b.len / (Py_ssize_t)(20 * sizeof(float));
    Py_ssize_t Lt2 = tp_b.len / (Py_ssize_t)(20 * sizeof(float));
    Py_ssize_t Lq = Lq2 - 2, Lt = Lt2 - 2;
    Lt1 = Lt + 1;
    Arr2f qp{(const float *)qp_b.buf, 20};
    Arr2f tp{(const float *)tp_b.buf, 20};
    Arr2d qtr{(const double *)qtr_b.buf, 7};
    Arr2d ttr{(const double *)ttr_b.buf, 7};
    const unsigned char *co = (const unsigned char *)co_b.buf;
    Arr2f ss{(const float *)ss_b.buf, Lt + 2};
    double *p_mm = (double *)pmm_b.buf;
    double *scale = (double *)sc_b.buf;
    unsigned char *bmac = (unsigned char *)bm_b.buf;
    const double DBL_MIN100 = 2.2250738585072014e-308 * 100.0;
    const float fshift = (float)shift;
    const double Cshift = pow(2.0, (double)fshift);

    std::vector<double> prev((Lt + 2) * 5, 0.0), curr((Lt + 2) * 5, 0.0);
    /* state col order matches the Python arrays: mm, mi, dg, im, gd */
    const int MMc = 0, MIc = 1, DGc = 2, IMc = 3, GDc = 4;
#define P(jj, s) prev[(jj) * 5 + (s)]
#define C(jj, s) curr[(jj) * 5 + (s)]

    /* ------------------------------- forward ------------------------ */
    double pmin = local ? 1.0 : 0.0;
    std::fill(curr.begin(), curr.end(), 0.0);
    for (Py_ssize_t j = 1; j <= Lt; j++) {
      if (co[1 * Lt1 + j]) continue;
      C(j, MMc) = (double)sp20(qp.row(1), tp.row(j)) * Cshift;
      C(j, IMc) = C(j - 1, MMc) * qtr.row(1)[T_M2I] * ttr.row(j - 1)[T_M2M]
                  + C(j - 1, IMc) * qtr.row(1)[T_I2I] * ttr.row(j - 1)[T_M2M];
      C(j, GDc) = C(j - 1, MMc) * ttr.row(j - 1)[T_M2D]
                  + C(j - 1, GDc) * ttr.row(j - 1)[T_D2D];
    }
    for (Py_ssize_t j = 0; j <= Lt; j++) p_mm[1 * Lt1 + j] = C(j, MMc);
    prev = curr;
    scale[0] = scale[1] = scale[2] = 1.0;
    double scale_prod = 1.0;

    for (Py_ssize_t i = 2; i <= Lq; i++) {
      const Py_ssize_t jmin = 1;
      if (scale_prod < DBL_MIN100)
        scale_prod = 0.0;
      else
        scale_prod *= scale[i];
      std::fill(curr.begin(), curr.end(), 0.0);
      const unsigned char *row_co = co + i * Lt1;
      const double *qi1 = qtr.row(i - 1);
      if (!row_co[jmin]) {
        /* reference quirk: ScoreSS at (1, Lt+1) for the jmin column */
        float ss0 = ss.row(1)[Lt + 1];
        C(jmin, MMc) = scale_prod * (double)fpow2f(ss0)
                       * (double)sp20(qp.row(i), tp.row(jmin)) * Cshift;
        C(jmin, MIc) = scale[i] * (P(jmin, MMc) * qi1[T_M2M]
                                       * ttr.row(jmin)[T_M2I]
                                   + P(jmin, MIc) * qi1[T_M2M]
                                         * ttr.row(jmin)[T_I2I]);
        C(jmin, DGc) = scale[i] * (P(jmin, MMc) * qi1[T_M2D]
                                   + P(jmin, DGc) * qi1[T_D2D]);
      }
      p_mm[i * Lt1 + jmin] = C(jmin, MMc);
      double Pmax_i = 0.0;
      const double *qi0 = qtr.row(i);
      for (Py_ssize_t j = jmin + 1; j <= Lt; j++) {
        if (row_co[j]) continue;
        const double *tj1 = ttr.row(j - 1);
        const double *tj0 = ttr.row(j);
        float ssv = ss.row(i)[j];
        double mm = (double)sp20(qp.row(i), tp.row(j)) * Cshift
                    * (double)fpow2f(ssv) * scale[i]
                    * (pmin
                       + P(j - 1, MMc) * qi1[T_M2M] * tj1[T_M2M]
                       + P(j - 1, GDc) * qi1[T_M2M] * tj1[T_D2M]
                       + P(j - 1, IMc) * qi1[T_I2M] * tj1[T_M2M]
                       + P(j - 1, DGc) * qi1[T_D2M] * tj1[T_M2M]
                       + P(j - 1, MIc) * qi1[T_M2M] * tj1[T_I2M]);
        C(j, MMc) = mm;
        C(j, GDc) = C(j - 1, MMc) * tj1[T_M2D] + C(j - 1, GDc) * tj1[T_D2D];
        C(j, IMc) = C(j - 1, MMc) * qi0[T_M2I] * tj1[T_M2M]
                    + C(j - 1, IMc) * qi0[T_I2I] * tj1[T_M2M];
        C(j, DGc) = scale[i] * (P(j, MMc) * qi1[T_M2D]
                                + P(j, DGc) * qi1[T_D2D]);
        C(j, MIc) = scale[i] * (P(j, MMc) * qi1[T_M2M] * tj0[T_M2I]
                                + P(j, MIc) * qi1[T_M2M] * tj0[T_I2I]);
        if (mm > Pmax_i) Pmax_i = mm;
      }
      for (Py_ssize_t j = 0; j <= Lt; j++) p_mm[i * Lt1 + j] = C(j, MMc);
      prev = curr;
      pmin *= scale[i];
      if (pmin < DBL_MIN100) pmin = 0.0;
      scale[i + 1] = 1.0 / (Pmax_i + 1.0);
    }

    double Pforward;
    if (local) {
      Pforward = 1.0;
      for (Py_ssize_t i = 1; i <= Lq; i++) {
        double s = 0.0;
        for (Py_ssize_t j = 1; j <= Lt; j++) s += p_mm[i * Lt1 + j];
        Pforward += s;
        Pforward *= scale[i + 1];
      }
    } else {
      Pforward = 0.0;
      for (Py_ssize_t i = 1; i < Lq; i++)
        Pforward = (Pforward + p_mm[i * Lt1 + Lt]) * scale[i + 1];
      double s = 0.0;
      for (Py_ssize_t j = 1; j <= Lt; j++) s += p_mm[Lq * Lt1 + j];
      Pforward += s;
      Pforward *= scale[Lq + 1];
    }

    double score = log2(Pforward) - 10.0;
    for (Py_ssize_t i = 1; i <= Lq + 1; i++) score -= log2(scale[i]);
    if (local)
      score -= log((double)(Lt * Lq)) / 0.388 + 14.0;

    /* sparse forward triples (hhforwardalgorithm.cpp:185-220) */
    PyObject *fwd = PyList_New(0);
    {
      double scale_prod_curr = 1.0;
      for (Py_ssize_t i = 1; i <= Lq; i++) {
        if (scale_prod_curr < DBL_MIN100)
          scale_prod_curr = 0.0;
        else
          scale_prod_curr *= scale[i];
        if (scale_prod_curr == 0.0) continue;
        double scale_rate = (scale_prod * scale[Lq + 1]) / scale_prod_curr;
        for (Py_ssize_t j = 1; j <= Lt; j++) {
          double v = p_mm[i * Lt1 + j] / Pforward * scale_rate;
          if (v > 1e-4) {
            PyObject *tup = Py_BuildValue("(nnd)", i, j, v);
            PyList_Append(fwd, tup);
            Py_DECREF(tup);
          }
        }
      }
    }

    /* ------------------------------- backward ----------------------- */
    std::fill(prev.begin(), prev.end(), 0.0);
    for (Py_ssize_t j = Lt; j >= 1; j--) {
      if (co[Lq * Lt1 + j]) {
        p_mm[Lq * Lt1 + j] = 0.0;
      } else {
        P(j, MMc) = scale[Lq + 1];
        p_mm[Lq * Lt1 + j] = p_mm[Lq * Lt1 + j] * scale[Lq + 1] / Pforward;
      }
    }
    pmin = local ? scale[Lq + 1] : 0.0;
    scale_prod = scale[Lq + 1];
    double final_scale_prod = scale[Lq + 1];
    for (Py_ssize_t i = Lq - 1; i >= 1; i--) {
      final_scale_prod *= scale[i + 1];
      if (final_scale_prod < DBL_MIN100) final_scale_prod = 0.0;
    }
    PyObject *bwd = PyList_New(0);

    for (Py_ssize_t i = Lq - 1; i >= 1; i--) {
      const Py_ssize_t jmin = 1;
      scale_prod *= scale[i + 1];
      if (scale_prod < DBL_MIN100) scale_prod = 0.0;
      std::fill(curr.begin(), curr.end(), 0.0);
      if (co[i * Lt1 + Lt]) {
        p_mm[i * Lt1 + Lt] = 0.0;
      } else {
        C(Lt, MMc) = scale_prod;
        p_mm[i * Lt1 + Lt] = p_mm[i * Lt1 + Lt] * scale_prod / Pforward;
      }
      pmin *= scale[i + 1];
      if (pmin < DBL_MIN100) pmin = 0.0;
      const unsigned char *row_co = co + i * Lt1;
      const double *qi0 = qtr.row(i);
      for (Py_ssize_t j = Lt - 1; j >= jmin; j--) {
        if (row_co[j]) continue;
        const double *tj0 = ttr.row(j);
        float ssv = ss.row(i + 1)[j + 1];
        double pmatch = P(j + 1, MMc)
                        * (double)sp20(qp.row(i + 1), tp.row(j + 1))
                        * (double)fpow2f(ssv) * Cshift * scale[i + 1];
        C(j, MMc) = pmin
                    + pmatch * qi0[T_M2M] * tj0[T_M2M]
                    + C(j + 1, GDc) * tj0[T_M2D]
                    + C(j + 1, IMc) * qi0[T_M2I] * tj0[T_M2M]
                    + P(j, DGc) * qi0[T_M2D] * scale[i + 1]
                    + P(j, MIc) * qi0[T_M2M] * tj0[T_M2I] * scale[i + 1];
        C(j, GDc) = pmatch * qi0[T_M2M] * tj0[T_D2M]
                    + C(j + 1, GDc) * tj0[T_D2D];
        C(j, IMc) = pmatch * qi0[T_I2M] * tj0[T_M2M]
                    + C(j + 1, IMc) * qi0[T_I2I] * tj0[T_M2M];
        C(j, DGc) = pmatch * qi0[T_D2M] * tj0[T_M2M]
                    + P(j, DGc) * qi0[T_D2D] * scale[i + 1];
        C(j, MIc) = pmatch * qi0[T_M2M] * tj0[T_I2M]
                    + P(j, MIc) * qi0[T_M2M] * tj0[T_I2I] * scale[i + 1];
      }
      for (Py_ssize_t jj = jmin; jj < Lt; jj++)
        p_mm[i * Lt1 + jj] *= C(jj, MMc) / Pforward;
      if (final_scale_prod != 0.0 && scale_prod != 0.0) {
        for (Py_ssize_t j = jmin; j < Lt; j++) {
          if (row_co[j] || C(j, MMc) == 0.0) continue;
          double val = (double)sp20(qp.row(i), tp.row(j)) * Cshift
                       * C(j, MMc) / Pforward * final_scale_prod
                       / scale_prod;
          if (val > 1e-4) {
            PyObject *tup = Py_BuildValue("(nnd)", i, j, val);
            PyList_Append(bwd, tup);
            Py_DECREF(tup);
          }
        }
      }
      prev = curr;
    }
    PyList_Sort(bwd);  /* (i, j, val) ascending, like sorted(bwd) */

    /* --------------------------------- MAC -------------------------- */
    Py_ssize_t hi2 = 0, hj2 = 0;
    {
      std::vector<float> S_prev(Lt + 1, 0.0f), S_curr(Lt + 1, 0.0f);
      double score_MAC = -3.402823466e+38;
      const float mact32 = (float)mact;
      const float half = 0.5f * mact32;
      const float NFLT_MIN = -1.175494351e-38f;
      for (Py_ssize_t i = 1; i <= Lq; i++) {
        std::fill(S_curr.begin(), S_curr.end(), 0.0f);
        const unsigned char *row_co = co + i * Lt1;
        const double *pr = p_mm + i * Lt1;
        unsigned char *br = bmac + i * Lt1;
        for (Py_ssize_t j = 1; j <= Lt; j++) {
          if (row_co[j]) {
            S_curr[j] = NFLT_MIN;
            br[j] = S_STOP;
            continue;
          }
          float post = (float)pr[j];
          float term1 = post - mact32;
          float term2 = (S_prev[j - 1] + post) - mact32;
          float term3 = S_prev[j] - half;
          float term4 = S_curr[j - 1] - half;
          float mx;
          unsigned char val;
          if (term1 > term2) {
            mx = term1;
            val = S_STOP;
          } else {
            mx = term2;
            val = S_MM;
          }
          if (term3 > mx) {
            mx = term3;
            val = S_MI;
          }
          if (term4 > mx) {
            mx = term4;
            val = S_IM;
          }
          S_curr[j] = mx;
          br[j] = val;
          if ((double)mx > score_MAC && (local || i == Lq)) {
            hi2 = i;
            hj2 = j;
            score_MAC = (double)mx;
          }
        }
        if (!local && (double)S_curr[Lt] > score_MAC) {
          hi2 = i;
          hj2 = Lt;
          score_MAC = (double)S_curr[Lt];
        }
        S_prev.swap(S_curr);
      }
    }

    ret = Py_BuildValue("(ddNNnn)", Pforward, score, fwd, bwd, hi2, hj2);
#undef P
#undef C
  }
  PyBuffer_Release(&qp_b);
  PyBuffer_Release(&tp_b);
  PyBuffer_Release(&qtr_b);
  PyBuffer_Release(&ttr_b);
  PyBuffer_Release(&co_b);
  PyBuffer_Release(&ss_b);
  PyBuffer_Release(&pmm_b);
  PyBuffer_Release(&sc_b);
  PyBuffer_Release(&bm_b);
  return ret;
}

/* ---------------------------------------------------------------------
 * parse_hhm_body(body: bytes, L: int, maxres: int)
 *   -> (nrows, trneff: bytes i32 (L+1,10), fvals: bytes i32 (nrows,20),
 *       lvals: bytes i32 (nrows,))
 *
 * The per-column hot loop of HMM::Read (src/hhhmm.cpp:468-607): `body`
 * starts at the line AFTER the "HMM ..." header and the transition
 * name line, i.e. with the column-0 transition record, and runs to
 * '//'/'#'/EOF.  Values are the raw fixed-point ints ('*' = 99999,
 * util.cpp:175-196); the float conversions stay in numpy so they are
 * bit-identical to the pure-Python reader.  Rows beyond min(L,
 * maxres-2) are consumed but not stored (hhhmm.cpp:475-481).
 */
static const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

/* next whitespace-separated token as fixed-point int; '*' -> 99999 */
static const char *next_int(const char *p, const char *end, int32_t *out) {
  p = skip_ws(p, end);
  if (p >= end || *p == '\n') { *out = 99999; return p; }
  if (*p == '*') { *out = 99999; p++; return p; }
  bool neg = false;
  if (*p == '-') { neg = true; p++; }
  long v = 0;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); p++; }
  /* skip any residual non-space garbage in the token */
  while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') p++;
  *out = (int32_t)(neg ? -v : v);
  return p;
}

static const char *next_line(const char *p, const char *end) {
  while (p < end && *p != '\n') p++;
  return p < end ? p + 1 : end;
}

static PyObject *parse_hhm_body(PyObject *, PyObject *args) {
  const char *buf;
  Py_ssize_t n;
  long L, maxres;
  if (!PyArg_ParseTuple(args, "y#ll", &buf, &n, &L, &maxres))
    return nullptr;
  const char *p = buf, *end = buf + n;
  long keep = std::min(L, maxres - 2);
  if (keep < 0) keep = 0;

  std::vector<int32_t> trneff((size_t)(L + 1) * 10, 99999);
  std::vector<int32_t> fvals;
  std::vector<int32_t> lvals;
  fvals.reserve((size_t)keep * 20);
  lvals.reserve((size_t)keep);

  /* column-0 transition record */
  p = skip_ws(p, end);
  for (int a = 0; a < 10; a++) p = next_int(p, end, &trneff[a]);
  p = next_line(p, end);

  long i = 0;
  while (p < end) {
    if (*p == '/' || *p == '#') break;
    const char *q = skip_ws(p, end);
    if (q >= end || *q == '\n') { p = next_line(p, end); continue; }
    /* emission line: <res> <i> <20 vals> <l> */
    i++;
    if (i > keep) { p = next_line(p, end); p = next_line(p, end); continue; }
    /* skip residue token */
    while (q < end && *q != ' ' && *q != '\t' && *q != '\n') q++;
    int32_t tmp;
    q = next_int(q, end, &tmp);            /* column index (ignored) */
    for (int a = 0; a < 20; a++) {
      int32_t v; q = next_int(q, end, &v); fvals.push_back(v);
    }
    q = skip_ws(q, end);
    if (q < end && *q != '\n') { int32_t lv; q = next_int(q, end, &lv);
                                 lvals.push_back(lv); }
    else lvals.push_back((int32_t)i);
    p = next_line(q, end);
    /* transition line: 7 transitions + 3 Neff */
    const char *t = p;
    for (int a = 0; a < 10; a++)
      t = next_int(t, end, &trneff[(size_t)i * 10 + a]);
    p = next_line(t, end);
  }

  long nrows = std::min(i, keep);
  PyObject *tr_b = PyBytes_FromStringAndSize(
      (const char *)trneff.data(), (Py_ssize_t)(trneff.size() * 4));
  PyObject *f_b = PyBytes_FromStringAndSize(
      (const char *)fvals.data(), (Py_ssize_t)(fvals.size() * 4));
  PyObject *l_b = PyBytes_FromStringAndSize(
      (const char *)lvals.data(), (Py_ssize_t)(lvals.size() * 4));
  PyObject *ret = Py_BuildValue("lNNN", nrows, tr_b, f_b, l_b);
  return ret;
}

/* qsort_int(v: bytes i32, k: bytes i32, left, right, up) -> bytes i32
 * The reference's quicksort (util.cpp:247-274): identical element
 * order including tie behavior (partition scheme defines the result;
 * greedy filters must visit sequences in exactly this order). */
static void qsort_int_rec(const int32_t *v, int32_t *k, long left,
                          long right, int up) {
  std::vector<std::pair<long, long>> stack;
  stack.emplace_back(left, right);
  while (!stack.empty()) {
    long lo = stack.back().first, hi = stack.back().second;
    stack.pop_back();
    if (lo >= hi) continue;
    long mid = (lo + hi) / 2;
    std::swap(k[lo], k[mid]);
    long last = lo;
    int32_t pivot = v[k[lo]];
    if (up == 1) {
      for (long i = lo + 1; i <= hi; i++)
        if (v[k[i]] < pivot) std::swap(k[++last], k[i]);
    } else {
      for (long i = lo + 1; i <= hi; i++)
        if (v[k[i]] > pivot) std::swap(k[++last], k[i]);
    }
    std::swap(k[lo], k[last]);
    stack.emplace_back(lo, last - 1);
    stack.emplace_back(last + 1, hi);
  }
}

static PyObject *qsort_int_native(PyObject *, PyObject *args) {
  const char *vb, *kb;
  Py_ssize_t vn, kn;
  long left, right, up;
  if (!PyArg_ParseTuple(args, "y#y#lll", &vb, &vn, &kb, &kn, &left,
                        &right, &up))
    return nullptr;
  PyObject *out = PyBytes_FromStringAndSize(kb, kn);
  if (!out) return nullptr;
  qsort_int_rec((const int32_t *)vb,
                (int32_t *)PyBytes_AS_STRING(out), left, right,
                (int)up);
  return out;
}

/* backtrace_score_terms(S, S_ss, nsteps, corr)
 *   S, S_ss: (nsteps+1,) float32 per-step scores (index 0 unused).
 * Returns (score_ss, corr_term) computed with the reference's exact
 * sequential float32 accumulation order (hhviterbi.cpp:224-252):
 *   score_ss = sum S_ss[1..n]
 *   corr_term = corr * Scorr with Scorr accumulated lag-by-lag
 *   (lag 1..4, each its own sequential pass).
 */
static PyObject *backtrace_score_terms(PyObject *, PyObject *args) {
  Py_buffer s_b, ss_b;
  int nsteps;
  float corr;
  if (!PyArg_ParseTuple(args, "y*y*if", &s_b, &ss_b, &nsteps, &corr))
    return nullptr;
  const float *S = (const float *)s_b.buf;
  const float *S_ss = (const float *)ss_b.buf;
  float score_ss = 0.0f;
  for (int step = 1; step <= nsteps; step++) score_ss += S_ss[step];
  float scorr = 0.0f;
  for (int lag = 1; lag <= 4; lag++)
    for (int step = 1 + lag; step <= nsteps; step++)
      scorr += S[step] * S[step - lag];
  float corr_term = corr * scorr;
  PyBuffer_Release(&s_b);
  PyBuffer_Release(&ss_b);
  return Py_BuildValue("ff", score_ss, corr_term);
}

/* band_set(co, R, C, pi, pj, n, W, Lq, Lt, value)
 *   co: writable uint8/bool (R, C) C-contiguous cell-off matrix.
 *   pi, pj: int64 path steps (monotone alignment path).
 * Sets co[si-W .. si+W, sj] and co[si, sj-W .. sj+W] = value for every
 * step, exactly like search/posterior.py:_band_set: per column j the
 * rows [min_i(j)-W, max_i(j)+W] clamped to [1, Lq], per row i the
 * columns [min_j(i)-W, max_j(i)+W] clamped to [1, Lt].  This is the
 * hot part of the Viterbi-band cell-off construction
 * (hhposteriordecoder.cpp:210-244, hhviterbi.cpp:61-77). */
static PyObject *band_set_native(PyObject *, PyObject *args) {
  Py_buffer co_b, pi_b, pj_b;
  int R, C, W, Lq, Lt, value;
  if (!PyArg_ParseTuple(args, "w*iiy*y*iiii", &co_b, &R, &C, &pi_b,
                        &pj_b, &W, &Lq, &Lt, &value))
    return nullptr;
  uint8_t *co = (uint8_t *)co_b.buf;
  const int64_t *pi = (const int64_t *)pi_b.buf;
  const int64_t *pj = (const int64_t *)pj_b.buf;
  Py_ssize_t n = pi_b.len / (Py_ssize_t)sizeof(int64_t);
  uint8_t v = value ? 1 : 0;
  std::vector<int> min_i((size_t)C, INT32_MAX), max_i((size_t)C, -1);
  std::vector<int> min_j((size_t)R, INT32_MAX), max_j((size_t)R, -1);
  for (Py_ssize_t k = 0; k < n; k++) {
    int i = (int)pi[k], j = (int)pj[k];
    if (j >= 0 && j < C) {
      if (i < min_i[j]) min_i[j] = i;
      if (i > max_i[j]) max_i[j] = i;
    }
    if (i >= 0 && i < R) {
      if (j < min_j[i]) min_j[i] = j;
      if (j > max_j[i]) max_j[i] = j;
    }
  }
  for (int j = 0; j < C; j++) {
    if (max_i[j] < 0) continue;
    int lo = min_i[j] - W, hi = max_i[j] + W;
    if (lo < 1) lo = 1;
    if (hi > Lq) hi = Lq;
    if (hi > R - 1) hi = R - 1;
    for (int r = lo; r <= hi; r++) co[(size_t)r * C + j] = v;
  }
  for (int i = 0; i < R; i++) {
    if (max_j[i] < 0) continue;
    int lo = min_j[i] - W, hi = max_j[i] + W;
    if (lo < 1) lo = 1;
    if (hi > Lt) hi = Lt;
    if (hi > C - 1) hi = C - 1;
    if (hi >= lo) memset(co + (size_t)i * C + lo, v, (size_t)(hi - lo + 1));
  }
  PyBuffer_Release(&co_b);
  PyBuffer_Release(&pi_b);
  PyBuffer_Release(&pj_b);
  Py_RETURN_NONE;
}

/* band_intervals(pi, pj, n, W, Lq, Lt, lo_c, hi_c, n_j, lo_r, hi_r, n_i)
 * Fill the ±W per-column / per-row band intervals around a path into
 * caller-provided int32 arrays (pre-filled lo=1, hi=0 = empty). */
static PyObject *band_intervals_native(PyObject *, PyObject *args) {
  Py_buffer pi_b, pj_b, loc_b, hic_b, lor_b, hir_b;
  int W, Lq, Lt, n_j, n_i;
  if (!PyArg_ParseTuple(args, "y*y*iiiw*w*iw*w*i", &pi_b, &pj_b, &W,
                        &Lq, &Lt, &loc_b, &hic_b, &n_j, &lor_b, &hir_b,
                        &n_i))
    return nullptr;
  const int64_t *pi = (const int64_t *)pi_b.buf;
  const int64_t *pj = (const int64_t *)pj_b.buf;
  Py_ssize_t n = pi_b.len / (Py_ssize_t)sizeof(int64_t);
  int32_t *lo_c = (int32_t *)loc_b.buf, *hi_c = (int32_t *)hic_b.buf;
  int32_t *lo_r = (int32_t *)lor_b.buf, *hi_r = (int32_t *)hir_b.buf;
  std::vector<int> min_i((size_t)n_j, INT32_MAX), max_i((size_t)n_j, -1);
  std::vector<int> min_j((size_t)n_i, INT32_MAX), max_j((size_t)n_i, -1);
  for (Py_ssize_t k = 0; k < n; k++) {
    int i = (int)pi[k], j = (int)pj[k];
    if (j >= 0 && j < n_j) {
      if (i < min_i[j]) min_i[j] = i;
      if (i > max_i[j]) max_i[j] = i;
    }
    if (i >= 0 && i < n_i) {
      if (j < min_j[i]) min_j[i] = j;
      if (j > max_j[i]) max_j[i] = j;
    }
  }
  for (int j = 0; j < n_j; j++) {
    if (max_i[j] < 0) { lo_c[j] = 1; hi_c[j] = 0; continue; }
    int lo = min_i[j] - W, hi = max_i[j] + W;
    lo_c[j] = lo < 1 ? 1 : lo;
    hi_c[j] = hi > Lq ? Lq : hi;
  }
  for (int i = 0; i < n_i; i++) {
    if (max_j[i] < 0) { lo_r[i] = 1; hi_r[i] = 0; continue; }
    int lo = min_j[i] - W, hi = max_j[i] + W;
    lo_r[i] = lo < 1 ? 1 : lo;
    hi_r[i] = hi > Lt ? Lt : hi;
  }
  PyBuffer_Release(&pi_b);
  PyBuffer_Release(&pj_b);
  PyBuffer_Release(&loc_b);
  PyBuffer_Release(&hic_b);
  PyBuffer_Release(&lor_b);
  PyBuffer_Release(&hir_b);
  Py_RETURN_NONE;
}

/* ---------------------------------------------------------------------
 * Batched backtrace decode + rescore for the Viterbi search funnel.
 *
 * Consumes the int8 walk payload produced on device by
 * ops/viterbi.py:_backtrace_walk_packed8 (per lane:
 * [score f32][i2 i16][j2 i16][n i32][state bytes, kmax]) and performs,
 * for every real lane, what search/viterbi_search.py's phase-2 decode
 * loop + ops/viterbi.py:backtrace_walk_unpack8 + the batched
 * scalar_prod20/fast_log2 rescore + backtrace_score_terms did in
 * Python/numpy — bit-identically:
 *   - walk positions reconstructed from (i2, j2) + state-determined
 *     moves (MM:-1,-1; GD/IM:0,-1; DG/MI:-1,0),
 *   - matched_cols counted from the RAW states (before the reference's
 *     trailing-MM overwrite, matching backtrace_walk_unpack8),
 *   - states[n] = MM overwrite (src/hhhit.cpp backtrace ends in MM),
 *   - per-MM-step S = fast_log2(scalar_prod20(q.p[i], t.p[j])) with
 *     the CALLER-PROVIDED LUT tables (so the C path shares Python's
 *     exact tables; fast_log2 = a + lg2[b] + diff[b]*c, f32,
 *     util-inl.h:108-129),
 *   - score_ss = 0 (this is the no-SS batch path), corr_term with the
 *     reference's sequential lag-by-lag f32 accumulation
 *     (hhviterbi.cpp:224-252), final score = f32(score + corr_term)
 *     when n > 0.
 * ------------------------------------------------------------------- */
static inline float flog2_lut(float x, const float *lg2,
                              const float *diff) {
  if (x <= 0.0f) return -100000.0f;
  int32_t bits;
  memcpy(&bits, &x, 4);
  float a = (float)(((bits & 0x7F800000) >> 23) - 0x7F);
  int b = (bits & 0x007FE000) >> 13;
  float c = (float)(bits & 0x00001FFF);
  return (a + lg2[b]) + diff[b] * c;
}

/* vit_decode_rescore(packed, kmax, B_real, qp, tp_seq, corr, lg2, diff,
 *                    ii2, jj2, st2, S2, score, scss, n_out, match_out,
 *                    i2_out, j2_out[, pnul])
 *   packed: (B, 12+kmax) int8 C; qp: (Lq+2, 20) f32 C;
 *   tp_seq: sequence of >= B_real f32 C arrays (Lt_b+2, 20);
 *   lg2/diff: (1025,) f32 fast_log2 tables (fastmath._fast_log2_tables);
 *   ii2/jj2: (B, K1) int32 zeroed; st2: (B, K1) int8 zeroed;
 *   S2: (B, K1) f32 zeroed (K1 >= max(n)+1);
 *   score/scss: (B,) f32; n/match/i2/j2_out: (B,) int32.
 *   pnul (optional): (B, 20) f32 per-lane null vectors — when given,
 *   tp rows are RAW profiles and the odds division
 *   (include_null_model's f32 divide, hhhmm.cpp:2139-2142) happens
 *   here element-wise, bit-identical to pre-dividing the array.
 */
static PyObject *vit_decode_rescore(PyObject *, PyObject *args) {
  Py_buffer pk_b, qp_b, lg2_b, dif_b, ii_b, jj_b, st_b, s2_b, sc_b,
      ss_b, n_b, m_b, i2_b, j2_b, pn_b;
  PyObject *tp_seq;
  int kmax, B_real;
  float corr;
  pn_b.buf = nullptr;
  if (!PyArg_ParseTuple(args, "y*iiy*Ofy*y*w*w*w*w*w*w*w*w*w*w*|y*",
                        &pk_b, &kmax, &B_real, &qp_b, &tp_seq, &corr,
                        &lg2_b, &dif_b, &ii_b, &jj_b, &st_b, &s2_b,
                        &sc_b, &ss_b, &n_b, &m_b, &i2_b, &j2_b, &pn_b))
    return nullptr;
  const float *pnul = (const float *)pn_b.buf;
  const Py_ssize_t W = 12 + kmax;
  const Py_ssize_t B = pk_b.len / W;
  /* row stride of the (B, K1) outputs, from the int8 st2 buffer */
  const Py_ssize_t K1c = st_b.len / (B ? B : 1);
  const float *lg2 = (const float *)lg2_b.buf;
  const float *dif = (const float *)dif_b.buf;
  Arr2f qp{(const float *)qp_b.buf, 20};
  const int8_t *pk = (const int8_t *)pk_b.buf;
  int32_t *ii2 = (int32_t *)ii_b.buf;
  int32_t *jj2 = (int32_t *)jj_b.buf;
  int8_t *st2 = (int8_t *)st_b.buf;
  float *S2 = (float *)s2_b.buf;
  float *sc_o = (float *)sc_b.buf;
  float *ss_o = (float *)ss_b.buf;
  int32_t *n_o = (int32_t *)n_b.buf;
  int32_t *m_o = (int32_t *)m_b.buf;
  int32_t *i2_o = (int32_t *)i2_b.buf;
  int32_t *j2_o = (int32_t *)j2_b.buf;

  PyObject *ret = nullptr;
  std::vector<Py_buffer> tps;
  tps.reserve((size_t)B_real);
  bool ok = true;
  for (int b = 0; b < B_real && ok; b++) {
    PyObject *item = PySequence_GetItem(tp_seq, b);
    Py_buffer tb;
    if (!item || PyObject_GetBuffer(item, &tb, PyBUF_SIMPLE) != 0) {
      Py_XDECREF(item);
      ok = false;
      break;
    }
    Py_DECREF(item);
    tps.push_back(tb);
  }
  if (ok) {
    for (Py_ssize_t b = 0; b < B_real; b++) {
      const int8_t *row = pk + b * W;
      float score;
      int16_t i2s, j2s;
      int32_t n;
      memcpy(&score, row, 4);
      memcpy(&i2s, row + 4, 2);
      memcpy(&j2s, row + 6, 2);
      memcpy(&n, row + 8, 4);
      if (n < 0) n = 0;
      if (n > kmax) n = kmax;
      const int8_t *st = row + 12;
      Arr2f tp{(const float *)tps[(size_t)b].buf, 20};
      /* bounds guards: walk positions come from the device payload;
       * clamp the S-lookup rows to the profile buffers so a corrupt
       * header cannot read out of bounds (real payloads never clamp) */
      const int32_t qp_rows = (int32_t)(qp_b.len / (20 * sizeof(float)));
      const int32_t tp_rows =
          (int32_t)(tps[(size_t)b].len / (20 * sizeof(float)));
      int32_t *iio = ii2 + b * K1c;
      int32_t *jjo = jj2 + b * K1c;
      int8_t *sto = st2 + b * K1c;
      float *so = S2 + b * K1c;
      int i = i2s, j = j2s, matched = 0;
      for (int32_t k = 0; k < n; k++) {
        int8_t s = st[k];
        if (s == S_MM) matched++;
        int di = (s == S_MM || s == S_DG || s == S_MI) ? 1 : 0;
        int dj = (s == S_MM || s == S_GD || s == S_IM) ? 1 : 0;
        iio[1 + k] = i;
        jjo[1 + k] = j;
        sto[1 + k] = s;
        i -= di;
        j -= dj;
      }
      if (n > 0) sto[n] = S_MM; /* reference trailing-MM overwrite */
      /* S on MM steps (post-overwrite mask, matching phase-2's
       * states[1:] == MM after unpack) */
      if (pnul) {
        const float *pn = pnul + b * 20;
        float tdiv[20];
        for (int32_t k = 1; k <= n; k++) {
          if (sto[k] == S_MM && iio[k] >= 0 && iio[k] < qp_rows &&
              jjo[k] >= 0 && jjo[k] < tp_rows) {
            const float *tr = tp.row(jjo[k]);
            for (int a = 0; a < 20; a++) tdiv[a] = tr[a] / pn[a];
            so[k] = flog2_lut(sp20(qp.row(iio[k]), tdiv), lg2, dif);
          }
        }
      } else {
        for (int32_t k = 1; k <= n; k++) {
          if (sto[k] == S_MM && iio[k] >= 0 && iio[k] < qp_rows &&
              jjo[k] >= 0 && jjo[k] < tp_rows)
            so[k] = flog2_lut(sp20(qp.row(iio[k]), tp.row(jjo[k])),
                              lg2, dif);
        }
      }
      /* correlation term, sequential f32 lag-by-lag */
      float scorr = 0.0f;
      for (int lag = 1; lag <= 4; lag++)
        for (int32_t step = 1 + lag; step <= n; step++)
          scorr += so[step] * so[step - lag];
      float sc = score;
      if (n > 0) sc = sc + corr * scorr;
      sc_o[b] = sc;
      ss_o[b] = 0.0f;
      n_o[b] = n;
      m_o[b] = matched;
      i2_o[b] = i2s;
      j2_o[b] = j2s;
    }
    ret = Py_None;
    Py_INCREF(ret);
  } else {
    PyErr_SetString(PyExc_TypeError,
                    "vit_decode_rescore: bad template buffer");
  }
  for (auto &tb : tps) PyBuffer_Release(&tb);
  PyBuffer_Release(&pk_b);
  PyBuffer_Release(&qp_b);
  PyBuffer_Release(&lg2_b);
  PyBuffer_Release(&dif_b);
  PyBuffer_Release(&ii_b);
  PyBuffer_Release(&jj_b);
  PyBuffer_Release(&st_b);
  PyBuffer_Release(&s2_b);
  PyBuffer_Release(&sc_b);
  PyBuffer_Release(&ss_b);
  PyBuffer_Release(&n_b);
  PyBuffer_Release(&m_b);
  PyBuffer_Release(&i2_b);
  PyBuffer_Release(&j2_b);
  if (pn_b.buf) PyBuffer_Release(&pn_b);
  return ret;
}

static PyMethodDef Methods[] = {
    {"parse_index", parse_index, METH_VARARGS,
     "parse .ffindex text -> list[(name, offset, length)]"},
    {"iter_ca3m_records", iter_ca3m_records, METH_VARARGS,
     "decode ca3m member records -> list[(entry, start, blocks)]"},
    {"expand_ca3m_record", expand_ca3m_record, METH_VARARGS,
     "expand one ca3m member record -> a3m row bytes"},
    {"posterior_fb_mac", posterior_fb_mac, METH_VARARGS,
     "Forward/Backward/MAC posterior decoding hot loops"},
    {"parse_hhm_body", parse_hhm_body, METH_VARARGS,
     "parse HHM per-column records -> raw fixed-point int arrays"},
    {"qsort_int", qsort_int_native, METH_VARARGS,
     "reference QSortInt permutation (util.cpp:247-274)"},
    {"backtrace_score_terms", backtrace_score_terms, METH_VARARGS,
     "sequential-f32 score_ss sum + correlation term"},
    {"band_set", band_set_native, METH_VARARGS,
     "±W band mask around an alignment path (cell-off construction)"},
    {"band_intervals", band_intervals_native, METH_VARARGS,
     "±W band intervals around an alignment path (compact mask form)"},
    {"vit_decode_rescore", vit_decode_rescore, METH_VARARGS,
     "batched walk-payload decode + scalar_prod20/fast_log2 rescore"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_hhsuite_native",
    "native runtime kernels (ffindex + ca3m)", -1, Methods};

PyMODINIT_FUNC PyInit__hhsuite_native(void) {
  return PyModule_Create(&moduledef);
}
