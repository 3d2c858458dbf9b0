// Native DER scoring core — md-eval.pl speaker-diarization semantics.
//
// Mirrors the Python reference implementation in ../der.py (itself validated
// against SCTK md-eval.pl golden outputs): same-speaker interval union for
// activity, collar cuts around RAW reference segment boundaries, elementary
// segment sweep with END-before-BEG ordering, Hungarian max-overlap speaker
// mapping computed over the un-collared UEM, and the per-segment
// MISS/FA/CONF accumulation. Exposed via a C ABI for ctypes; built on demand
// by score/native_build.py.
//
// This is the hot path when scoring large corpora (thousands of recordings ×
// threshold sweeps): the sweep is O(E log E) per file and allocation-light.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr double kEps = 1e-8;

struct Interval {
  double s, e;
};

// union of possibly-overlapping intervals (sorted in place)
std::vector<Interval> merge_intervals(std::vector<Interval> iv) {
  if (iv.empty()) return iv;
  std::sort(iv.begin(), iv.end(), [](const Interval& a, const Interval& b) { return a.s < b.s; });
  std::vector<Interval> out;
  out.push_back(iv[0]);
  for (size_t i = 1; i < iv.size(); ++i) {
    if (iv[i].s <= out.back().e + kEps) {
      out.back().e = std::max(out.back().e, iv[i].e);
    } else {
      out.push_back(iv[i]);
    }
  }
  return out;
}

// uem minus cuts (cuts need not be disjoint; sorted by start)
std::vector<Interval> subtract(const std::vector<Interval>& uem, std::vector<Interval> cuts) {
  if (cuts.empty()) return uem;
  std::sort(cuts.begin(), cuts.end(), [](const Interval& a, const Interval& b) { return a.s < b.s; });
  std::vector<Interval> out;
  for (const auto& u : uem) {
    double cur = u.s;
    for (const auto& c : cuts) {
      if (c.e <= cur || c.s >= u.e) continue;
      if (c.s > cur) out.push_back({cur, std::min(c.s, u.e)});
      cur = std::max(cur, c.e);
      if (cur >= u.e) break;
    }
    if (cur < u.e) out.push_back({cur, u.e});
  }
  std::vector<Interval> nz;
  for (auto& o : out)
    if (o.e > o.s + kEps) nz.push_back(o);
  return nz;
}

struct Event {
  double t;
  int order;  // 0 = END, 1 = BEG (END sorts first at equal time)
  int kind;   // 0 = uem, 1 = ref, 2 = sys
  int who;
  int delta;
};

struct Segment {
  double dur;
  // active speaker bitmask-free sets are tracked during sweep; stats
  // accumulate inline, so Segment itself is not stored.
};

struct Stats {
  double scored_speaker = 0, missed_speaker = 0, falarm_speaker = 0, speaker_error = 0;
  double scored_time = 0, scored_speech = 0, missed_speech = 0, falarm_speech = 0;
};

// sweep over elementary segments; cb(dur, ref_active, sys_active)
template <typename F>
void sweep(const std::vector<Interval>& uem,
           const std::vector<std::vector<Interval>>& ref,
           const std::vector<std::vector<Interval>>& sys, F&& cb) {
  std::vector<Event> events;
  for (const auto& u : uem) {
    if (u.e <= u.s + kEps) continue;
    events.push_back({u.s, 1, 0, 0, 1});
    events.push_back({u.e, 0, 0, 0, -1});
  }
  for (size_t k = 0; k < ref.size(); ++k)
    for (const auto& iv : ref[k]) {
      events.push_back({iv.s, 1, 1, (int)k, 1});
      events.push_back({iv.e, 0, 1, (int)k, -1});
    }
  for (size_t k = 0; k < sys.size(); ++k)
    for (const auto& iv : sys[k]) {
      events.push_back({iv.s, 1, 2, (int)k, 1});
      events.push_back({iv.e, 0, 2, (int)k, -1});
    }
  std::sort(events.begin(), events.end(), [](const Event& a, const Event& b) {
    if (a.t != b.t) return a.t < b.t;
    return a.order < b.order;
  });
  std::vector<int> ref_c(ref.size(), 0), sys_c(sys.size(), 0);
  bool evaluate = false;
  double tbeg = 0;
  for (const auto& ev : events) {
    if (evaluate && tbeg < ev.t - kEps) {
      cb(ev.t - tbeg, ref_c, sys_c);
      tbeg = ev.t;
    }
    if (ev.kind == 0) {
      evaluate = ev.delta > 0;
      if (evaluate) tbeg = ev.t;
    } else if (ev.kind == 1) {
      ref_c[ev.who] += ev.delta;
    } else {
      sys_c[ev.who] += ev.delta;
    }
  }
}

// Hungarian algorithm (maximize total weight), O(n^3); returns col of each
// row (-1 if none). Weights must be >= 0; zero-weight pairs are unmapped.
std::vector<int> hungarian_max(const std::vector<std::vector<double>>& w, int nr, int nc) {
  int n = std::max(nr, nc);
  const double INF = 1e18;
  // convert to min-cost: cost = maxw - w
  double maxw = 0;
  for (int i = 0; i < nr; ++i)
    for (int j = 0; j < nc; ++j) maxw = std::max(maxw, w[i][j]);
  std::vector<std::vector<double>> a(n + 1, std::vector<double>(n + 1, maxw));
  for (int i = 0; i < nr; ++i)
    for (int j = 0; j < nc; ++j) a[i + 1][j + 1] = maxw - w[i][j];
  std::vector<double> u(n + 1), v(n + 1);
  std::vector<int> p(n + 1), way(n + 1);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(n + 1, INF);
    std::vector<char> used(n + 1, false);
    do {
      used[j0] = true;
      int i0 = p[j0], j1 = 0;
      double delta = INF;
      for (int j = 1; j <= n; ++j)
        if (!used[j]) {
          double cur = a[i0][j] - u[i0] - v[j];
          if (cur < minv[j]) {
            minv[j] = cur;
            way[j] = j0;
          }
          if (minv[j] < delta) {
            delta = minv[j];
            j1 = j;
          }
        }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  std::vector<int> match(nr, -1);
  for (int j = 1; j <= n; ++j) {
    int i = p[j];
    if (i >= 1 && i <= nr && j <= nc && w[i - 1][j - 1] > 0) match[i - 1] = j - 1;
  }
  return match;
}

}  // namespace

extern "C" {

// Score one recording. Outputs 8 stats + per-ref-speaker mapping.
// out_stats: [scored_speaker, missed_speaker, falarm_speaker, speaker_error,
//             scored_time, scored_speech, missed_speech, falarm_speech]
// out_map:   length n_ref_spk, sys speaker index or -1.
int sdt_score_der_file(const double* ref_start, const double* ref_end, const int32_t* ref_spk,
                       int n_ref, int n_ref_spk, const double* sys_start, const double* sys_end,
                       const int32_t* sys_spk, int n_sys, int n_sys_spk, const double* uem_start,
                       const double* uem_end, int n_uem, double collar, int overlap_limit,
                       double* out_stats, int32_t* out_map) {
  std::vector<std::vector<Interval>> ref(n_ref_spk), sys(n_sys_spk);
  for (int i = 0; i < n_ref; ++i)
    if (ref_end[i] > ref_start[i]) ref[ref_spk[i]].push_back({ref_start[i], ref_end[i]});
  for (int i = 0; i < n_sys; ++i)
    if (sys_end[i] > sys_start[i]) sys[sys_spk[i]].push_back({sys_start[i], sys_end[i]});
  for (auto& v : ref) v = merge_intervals(v);
  for (auto& v : sys) v = merge_intervals(v);

  std::vector<Interval> uem;
  if (n_uem > 0) {
    for (int i = 0; i < n_uem; ++i) uem.push_back({uem_start[i], uem_end[i]});
  } else {
    double lo = 1e30, hi = -1e30;
    for (const auto& v : ref)
      for (const auto& iv : v) {
        lo = std::min(lo, iv.s);
        hi = std::max(hi, iv.e);
      }
    if (hi > lo) uem.push_back({lo, hi});
  }

  // speaker mapping over un-collared UEM
  std::vector<std::vector<double>> overlap(n_ref_spk, std::vector<double>(n_sys_spk, 0.0));
  sweep(uem, ref, sys, [&](double dur, const std::vector<int>& rc, const std::vector<int>& sc) {
    bool any_ref = false;
    for (int c : rc)
      if (c > 0) any_ref = true;
    if (!any_ref) return;
    for (int i = 0; i < (int)rc.size(); ++i)
      if (rc[i] > 0)
        for (int j = 0; j < (int)sc.size(); ++j)
          if (sc[j] > 0) overlap[i][j] += dur;
  });
  std::vector<int> map =
      (n_ref_spk && n_sys_spk) ? hungarian_max(overlap, n_ref_spk, n_sys_spk) : std::vector<int>(n_ref_spk, -1);
  for (int i = 0; i < n_ref_spk; ++i) out_map[i] = map[i];

  // scoring UEM: cut collars around RAW ref boundaries
  std::vector<Interval> score_uem = uem;
  if (collar > 0) {
    std::vector<Interval> cuts;
    for (int i = 0; i < n_ref; ++i)
      if (ref_end[i] > ref_start[i]) {
        cuts.push_back({ref_start[i] - collar, ref_start[i] + collar});
        cuts.push_back({ref_end[i] - collar, ref_end[i] + collar});
      }
    score_uem = subtract(score_uem, cuts);
  }
  if (overlap_limit) {
    // regions with >= 2 ref speakers active
    std::vector<Event> ev2;
    for (const auto& v : ref)
      for (const auto& iv : v) {
        ev2.push_back({iv.s, 1, 1, 0, 1});
        ev2.push_back({iv.e, 0, 1, 0, -1});
      }
    std::sort(ev2.begin(), ev2.end(), [](const Event& a, const Event& b) {
      if (a.t != b.t) return a.t < b.t;
      return a.order < b.order;
    });
    std::vector<Interval> olap;
    int cnt = 0;
    double st = 0;
    for (const auto& e : ev2) {
      int was = cnt;
      cnt += e.delta;
      if (was < 2 && cnt >= 2) st = e.t;
      if (was >= 2 && cnt < 2) olap.push_back({st, e.t});
    }
    score_uem = subtract(score_uem, olap);
  }

  Stats st;
  sweep(score_uem, ref, sys, [&](double dur, const std::vector<int>& rc, const std::vector<int>& sc) {
    int nref = 0, nsys = 0, nmap = 0;
    for (int c : rc) nref += c > 0;
    for (int c : sc) nsys += c > 0;
    for (int i = 0; i < (int)rc.size(); ++i)
      if (rc[i] > 0 && map[i] >= 0 && sc[map[i]] > 0) ++nmap;
    st.scored_time += dur;
    if (nref) {
      st.scored_speech += dur;
      if (!nsys) st.missed_speech += dur;
    } else if (nsys) {
      st.falarm_speech += dur;
    }
    st.scored_speaker += dur * nref;
    st.missed_speaker += dur * std::max(nref - nsys, 0);
    st.falarm_speaker += dur * std::max(nsys - nref, 0);
    st.speaker_error += dur * (std::min(nref, nsys) - nmap);
  });

  out_stats[0] = st.scored_speaker;
  out_stats[1] = st.missed_speaker;
  out_stats[2] = st.falarm_speaker;
  out_stats[3] = st.speaker_error;
  out_stats[4] = st.scored_time;
  out_stats[5] = st.scored_speech;
  out_stats[6] = st.missed_speech;
  out_stats[7] = st.falarm_speech;
  return 0;
}

// RTTM line validator: returns number of invalid lines found (basic checks:
// type SPEAKER, numeric start/dur, non-negative dur). Buffer-based so the
// Python side can validate large files without per-line overhead.
int sdt_validate_rttm(const char* buf, int64_t len, int64_t* bad_line_out) {
  int bad = 0;
  int64_t line_no = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) nl = end;
    ++line_no;
    // parse: TYPE FILE CHNL TBEG TDUR ...
    const char* q = p;
    auto skip_ws = [&]() { while (q < nl && (*q == ' ' || *q == '\t')) ++q; };
    auto token = [&]() {
      skip_ws();
      const char* s = q;
      while (q < nl && *q != ' ' && *q != '\t') ++q;
      return std::string(s, q - s);
    };
    std::string type = token();
    if (!type.empty()) {
      std::string file = token(), chnl = token(), tbeg = token(), tdur = token();
      bool ok = type == "SPEAKER" || type == "SPKR-INFO" || type == "NON-LEX" || type == "NOSCORE" ||
                type == "LEXEME" || type == "SEGMENT" || type == "SU";
      if (ok && type == "SPEAKER") {
        char* e1 = nullptr;
        char* e2 = nullptr;
        double b = strtod(tbeg.c_str(), &e1);
        double d = strtod(tdur.c_str(), &e2);
        if (*e1 != 0 || *e2 != 0 || d < 0 || b < 0) ok = false;
      }
      if (!ok) {
        if (bad == 0 && bad_line_out) *bad_line_out = line_no;
        ++bad;
      }
    }
    p = nl + 1;
  }
  return bad;
}

}  // extern "C"
