// See policy_runtime.h. Dependency-free C++17; built by build.sh into
// libgrxpolicy.so and driven from Python via ctypes (deploy/runtime.py) or
// directly from a robot-side control loop.

#include "policy_runtime.h"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x47525850;

struct Layer {
  uint32_t in_dim = 0;
  uint32_t out_dim = 0;
  std::vector<float> w;  // in x out, row-major
  std::vector<float> b;
};

struct LstmLayer {
  uint32_t in_dim = 0;
  uint32_t hidden = 0;
  std::vector<float> w_ih;  // in x 4H, row-major (gate order i, f, g, o)
  std::vector<float> w_hh;  // H x 4H
  std::vector<float> b;     // 4H (b_ih + b_hh folded at export)
};

inline float activate(float x, uint32_t act_id) {
  switch (act_id) {
    case 0:  // elu
      return x > 0.0f ? x : std::expm1(x);
    case 1:  // relu
      return x > 0.0f ? x : 0.0f;
    case 2:  // tanh
      return std::tanh(x);
    default:
      return x;
  }
}

inline float sigmoidf(float x) { return 1.0f / (1.0f + std::exp(-x)); }

}  // namespace

struct GrxPolicy {
  uint32_t act_id = 0;
  std::vector<Layer> layers;
  std::vector<LstmLayer> lstm;
  // recurrent state, one (h, c) pair per LSTM layer (batch-1 streaming,
  // PolicyExporterLSTM semantics)
  std::vector<std::vector<float>> h_state, c_state;
  mutable std::vector<float> scratch_a, scratch_b, gates;
};

extern "C" {

GrxPolicy* grx_policy_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto fail = [&](GrxPolicy* p) -> GrxPolicy* {
    delete p;
    std::fclose(f);
    return nullptr;
  };

  uint32_t header[4];
  if (std::fread(header, sizeof(uint32_t), 4, f) != 4) return fail(nullptr);
  if (header[0] != kMagic || (header[1] != 1 && header[1] != 2)) return fail(nullptr);

  auto* p = new GrxPolicy();
  p->act_id = header[3];
  size_t max_dim = 0;

  if (header[1] == 2) {
    uint32_t rnn[2];
    if (std::fread(rnn, sizeof(uint32_t), 2, f) != 2) return fail(p);
    p->lstm.resize(rnn[0]);
    const uint32_t hidden = rnn[1];
    for (auto& l : p->lstm) {
      uint32_t in_dim;
      if (std::fread(&in_dim, sizeof(uint32_t), 1, f) != 1) return fail(p);
      l.in_dim = in_dim;
      l.hidden = hidden;
      l.w_ih.resize(size_t(in_dim) * 4 * hidden);
      l.w_hh.resize(size_t(hidden) * 4 * hidden);
      l.b.resize(size_t(4) * hidden);
      if (std::fread(l.w_ih.data(), sizeof(float), l.w_ih.size(), f) != l.w_ih.size() ||
          std::fread(l.w_hh.data(), sizeof(float), l.w_hh.size(), f) != l.w_hh.size() ||
          std::fread(l.b.data(), sizeof(float), l.b.size(), f) != l.b.size()) {
        return fail(p);
      }
      max_dim = std::max(max_dim, size_t(std::max(in_dim, hidden)));
      p->h_state.emplace_back(hidden, 0.0f);
      p->c_state.emplace_back(hidden, 0.0f);
    }
    if (!p->lstm.empty()) p->gates.resize(size_t(4) * hidden);
  }

  p->layers.resize(header[2]);
  for (auto& layer : p->layers) {
    uint32_t dims[2];
    if (std::fread(dims, sizeof(uint32_t), 2, f) != 2) return fail(p);
    layer.in_dim = dims[0];
    layer.out_dim = dims[1];
    layer.w.resize(size_t(dims[0]) * dims[1]);
    layer.b.resize(dims[1]);
    if (std::fread(layer.w.data(), sizeof(float), layer.w.size(), f) != layer.w.size() ||
        std::fread(layer.b.data(), sizeof(float), layer.b.size(), f) != layer.b.size()) {
      return fail(p);
    }
    max_dim = std::max(max_dim, size_t(std::max(dims[0], dims[1])));
  }
  std::fclose(f);
  p->scratch_a.resize(max_dim);
  p->scratch_b.resize(max_dim);
  return p;
}

int grx_policy_input_dim(const GrxPolicy* p) {
  if (!p) return -1;
  if (!p->lstm.empty()) return int(p->lstm.front().in_dim);
  return p->layers.empty() ? -1 : int(p->layers.front().in_dim);
}

int grx_policy_output_dim(const GrxPolicy* p) {
  return p && !p->layers.empty() ? int(p->layers.back().out_dim) : -1;
}

int grx_policy_num_lstm_layers(const GrxPolicy* p) {
  return p ? int(p->lstm.size()) : -1;
}

int grx_policy_forward(GrxPolicy* p, const float* obs, float* act) {
  if (!p || p->layers.empty()) return 1;
  const float* x = obs;
  float* cur = p->scratch_a.data();
  float* nxt = p->scratch_b.data();

  // LSTM memory stack (gate order i, f, g, o; matches learn/recurrent.py
  // _lstm_cell == torch.nn.LSTM)
  for (size_t li = 0; li < p->lstm.size(); ++li) {
    const LstmLayer& l = p->lstm[li];
    const uint32_t hd = l.hidden;
    float* g = p->gates.data();
    std::memcpy(g, l.b.data(), sizeof(float) * 4 * hd);
    for (uint32_t i = 0; i < l.in_dim; ++i) {
      const float xi = x[i];
      const float* wrow = l.w_ih.data() + size_t(i) * 4 * hd;
      for (uint32_t o = 0; o < 4 * hd; ++o) g[o] += xi * wrow[o];
    }
    const float* h = p->h_state[li].data();
    for (uint32_t i = 0; i < hd; ++i) {
      const float hi = h[i];
      const float* wrow = l.w_hh.data() + size_t(i) * 4 * hd;
      for (uint32_t o = 0; o < 4 * hd; ++o) g[o] += hi * wrow[o];
    }
    float* hs = p->h_state[li].data();
    float* cs = p->c_state[li].data();
    for (uint32_t o = 0; o < hd; ++o) {
      const float ig = sigmoidf(g[o]);
      const float fg = sigmoidf(g[hd + o]);
      const float gg = std::tanh(g[2 * hd + o]);
      const float og = sigmoidf(g[3 * hd + o]);
      cs[o] = fg * cs[o] + ig * gg;
      hs[o] = og * std::tanh(cs[o]);
      nxt[o] = hs[o];
    }
    std::swap(cur, nxt);
    x = cur;
  }

  size_t n_layers = p->layers.size();
  for (size_t li = 0; li < n_layers; ++li) {
    const Layer& layer = p->layers[li];
    for (uint32_t o = 0; o < layer.out_dim; ++o) nxt[o] = layer.b[o];
    for (uint32_t i = 0; i < layer.in_dim; ++i) {
      const float xi = x[i];
      const float* wrow = layer.w.data() + size_t(i) * layer.out_dim;
      for (uint32_t o = 0; o < layer.out_dim; ++o) nxt[o] += xi * wrow[o];
    }
    const bool last = (li + 1 == n_layers);
    if (!last) {
      for (uint32_t o = 0; o < layer.out_dim; ++o) nxt[o] = activate(nxt[o], p->act_id);
    }
    std::swap(cur, nxt);
    x = cur;
  }
  std::memcpy(act, x, sizeof(float) * p->layers.back().out_dim);
  return 0;
}

int grx_policy_forward_batch(GrxPolicy* p, const float* obs, float* act, int n) {
  if (!p || p->layers.empty()) return 1;
  const int in = grx_policy_input_dim(p);
  const int out = grx_policy_output_dim(p);
  for (int k = 0; k < n; ++k) {
    int rc = grx_policy_forward(p, obs + size_t(k) * in, act + size_t(k) * out);
    if (rc) return rc;
  }
  return 0;
}

void grx_policy_reset(GrxPolicy* p) {
  if (!p) return;
  for (auto& h : p->h_state) std::fill(h.begin(), h.end(), 0.0f);
  for (auto& c : p->c_state) std::fill(c.begin(), c.end(), 0.0f);
}

void grx_policy_free(GrxPolicy* p) { delete p; }

}  // extern "C"
