// K3's kernels (csrc/ppo_update.cu) compiled for the host CPU with the
// built-ins of csrc/host/cuda_runtime.h: runs the fused step (every block's
// threads at once, the grid barrier a barrier over all of them) and the
// reference pair k3_norm + k3_adam (block by block) on the same inputs, and
// writes both results. tests/test_torch_k3_host.py builds it with
// -fsanitize=thread:
//
//   g++ -std=c++17 -O1 -g -fsanitize=thread -ffp-contract=off -pthread \
//       -I csrc/host csrc/host/k3_host.cpp -o k3_host
//   k3_host <input> <output>
//
// input:  int32 sizeof(K3Args), K3Args (pointers ignored), int32 step,
//         int32 count0, f32 state[16], f32 aux[4], f32 p, m, v, g [n each]
// output: for the fused step, then the reference pair: f32 p, m, v, g [n
//         each], state[16], step record[4], part[nblocks]
#define K3_KERNELS_ONLY
#define K3_SMEM(name) K3Smem& name = cuda_host::block_smem<K3Smem>()
#include "../ppo_update.cu"

#include <vector>

namespace {

struct Buffers {
  std::vector<float> p, m, v, g, state, step, part;
  std::vector<float> aux;
  int count0 = 0;

  K3Args bind(K3Args a) {
    a.p = p.data();
    a.m = m.data();
    a.v = v.data();
    a.g = g.data();
    a.aux = aux.data();
    a.state = state.data();
    a.count0 = &count0;
    a.part = part.data();
    a.step = step.data();
    return a;
  }

  void write(std::FILE* f) const {
    for (const auto* x : {&p, &m, &v, &g, &state, &step, &part}) std::fwrite(x->data(), sizeof(float), x->size(), f);
  }
};

bool read(std::FILE* f, void* dst, size_t bytes) { return std::fread(dst, 1, bytes, f) == bytes; }

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    std::fprintf(stderr, "usage: %s <input> <output>\n", argv[0]);
    return 2;
  }
  std::FILE* in = std::fopen(argv[1], "rb");
  if (!in) {
    std::fprintf(stderr, "k3_host: cannot open %s\n", argv[1]);
    return 2;
  }
  int size = 0, s = 0;
  K3Args a;
  Buffers b;
  bool ok = read(in, &size, sizeof size) && size == (int)sizeof(K3Args) && read(in, &a, sizeof a) &&
            read(in, &s, sizeof s) && read(in, &b.count0, sizeof b.count0);
  ok = ok && fits(&a);
  if (ok) {
    const size_t n = (size_t)a.n;
    b.state.resize(16);
    b.aux.resize(4);
    b.p.resize(n);
    b.m.resize(n);
    b.v.resize(n);
    b.g.resize(n);
    b.step.assign(4, 0.f);
    b.part.assign((size_t)a.nblocks, 0.f);
    for (auto* x : {&b.state, &b.aux, &b.p, &b.m, &b.v, &b.g}) ok = ok && read(in, x->data(), x->size() * sizeof(float));
  }
  std::fclose(in);
  if (!ok) {
    std::fprintf(stderr, "k3_host: bad input %s (K3Args is %d bytes here, the file says %d)\n", argv[1],
                 (int)sizeof(K3Args), size);
    return 2;
  }

  Buffers fused = b, ref = b;
  const K3Args af = fused.bind(a), ar = ref.bind(a);
  const unsigned nb = (unsigned)a.nblocks;
  cuda_host::launch(nb, THREADS, sizeof(K3Smem), true, [&] { k3_fused_step(af, s); });
  cuda_host::launch(nb, THREADS, sizeof(K3Smem), false, [&] { k3_norm(ar); });
  cuda_host::launch(nb, THREADS, sizeof(K3Smem), false, [&] { k3_adam(ar, s); });

  std::FILE* out = std::fopen(argv[2], "wb");
  if (!out) {
    std::fprintf(stderr, "k3_host: cannot write %s\n", argv[2]);
    return 2;
  }
  fused.write(out);
  ref.write(out);
  std::fclose(out);

  // every word of the two results, compared by bit pattern (NaN lanes included)
  long long words = 0, differ = 0;
  const std::vector<float>* fx[] = {&fused.p, &fused.m, &fused.v, &fused.g, &fused.state, &fused.step, &fused.part};
  const std::vector<float>* rx[] = {&ref.p, &ref.m, &ref.v, &ref.g, &ref.state, &ref.step, &ref.part};
  for (int k = 0; k < 7; ++k)
    for (size_t i = 0; i < fx[k]->size(); ++i, ++words)
      differ += std::memcmp(&(*fx[k])[i], &(*rx[k])[i], sizeof(float)) != 0;
  std::printf("k3_host: n %lld, %d blocks, step %d: fused vs reference %lld differing words of %lld\n", a.n,
              a.nblocks, s, differ, words);
  return 0;
}
