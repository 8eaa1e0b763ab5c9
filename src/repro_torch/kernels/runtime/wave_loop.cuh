// The drive, the cascade waves and the outputs of one block of the
// kernels that run the AFM cascade on the weights (fused.cu after its
// search and Eq. 3 merge, cascade.cu's drive_cascade after the staged
// step's merge), as statements: each kernel's body includes this file at
// the point where its slice, counters and draws are in shared memory. It is
// text and not a function because fused.cu runs at its 128-register cap,
// and there every function boundary tried around this code, inlined or
// not, made the register allocator spill more and the kernel slower on an
// H100 than the same code written in place; included text compiles as if
// written in place. The design is described in runtime/waves.cuh.
//
// Names the including body defines:
//   THREADS (threads a block), tid, g (this block), n, side, d, ds (features
//     a block; (d + ds - 1) / ds blocks own features), f0 and nf (this
//     block's features), staged (waves of draws in shared memory), clean
//     (whether this thread's weights are all steady);
//   in shared memory: wa and wb (float*, the slice feature-major, swapped
//     each wave), c, recv, cnt (the adaptations of each unit this step),
//     fgen (-1), acc (2 n, zero), fronts, receivers (uint16_t*), nbr (edge
//     masks, repro::edge_mask), drive (8 n), draws (4 n a staged wave), and
//     the flags dirty, n_front[2] and n_recv[3] (zero);
//   p, the kernel's parameters: theta, budget, bern (the draws in device
//     memory), l_c, out2 (two features a store), w_out, fired_out,
//     stats_out ([size, waves]), c_out and recv_out.
// No include guard: it is included once in each kernel's body.
  // ---- the counter drive, a thread a site (from the top, so it runs
  // beside work that starts at thread 0): each of unit u's cnt[u]
  // adaptations, at most 8, adds its draw; the units at threshold form the
  // first front
  for (int u = THREADS - 1 - tid; u < n; u += THREADS) {   // from the top
    const int k = min(cnt[u], 8);
    int inc = 0;
    for (int j = 0; j < k; ++j) inc += drive[j * n + u] != 0;
    const int cv = c[u] + inc;
    c[u] = cv;
    if (cv >= p.theta) fronts[atomicAdd(&n_front[0], 1)] = u;
  }
  if (!clean) *dirty = 1;
  __syncthreads();

  // ---- 4. waves, until the front is empty or the budget is spent
  int size = 0, waves = 0;
  while (n_front[waves & 1] > 0 && waves < p.budget) {
    const int k = waves;
    const int nfront = n_front[k & 1];
    const uint16_t* front = fronts + (k & 1) * n;
    uint16_t* next_front = fronts + ((k + 1) & 1) * n;
    uint16_t* cur = receivers + (k & 1) * n;        // receivers of wave k
    const uint16_t* prev = receivers + ((k + 1) & 1) * n;   // of wave k - 1
    int32_t* acc_k = acc + (k & 1) * n;
    const uint8_t* bw =
        (k < staged ? draws : p.bern) + static_cast<size_t>(k) * 4 * n;
    // the flag is read before the barrier after which it may change
    const bool full = *dirty != 0;
    size += nfront;
    // push: a fired site v sends to the site above it (for which v is
    // below: slot 0), below it (slot 1), left of it (slot 2), right of it
    // (slot 3); a receipt adds 1 to the packed count, a draw 256
    for (int e = tid; e < 4 * nfront; e += THREADS) {
      const int v = front[e >> 2], dir = e & 3;
      const int m = nbr[v];
      if (dir == 0) fgen[v] = k;
      if (!(m & (dir == 0 ? 2 : dir == 1 ? 1 : dir == 2 ? 8 : 4))) continue;
      const int u = dir == 0 ? v - side : dir == 1 ? v + side
                  : dir == 2 ? v - 1 : v + 1;
      const int add = 1 + (bw[dir * n + u] != 0 ? 256 : 0);
      if (atomicAdd(&acc_k[u], add) == 0)
        cur[atomicAdd(&n_recv[k % 3], 1)] = u;
    }
    // last wave's receipts are read: clear them for wave k + 1 (threads
    // from the top, so the few pushes and these run side by side)
    for (int i = THREADS - 1 - tid; i < n_recv[(k + 2) % 3]; i += THREADS)
      acc[((k + 1) & 1) * n + prev[i]] = 0;
    if (tid == 0) {
      n_front[(k + 1) & 1] = 0;
      n_recv[(k + 1) % 3] = 0;
    }
    __syncthreads();
    // update: counters of the receivers (in place) and of the fired sites
    // that receive nothing (reset), the next front, and the weights; the
    // three lists start at different threads
    const int nrc = n_recv[k % 3];
    for (int i = tid; i < nrc; i += THREADS) {
      const int u = cur[i];
      const int a = acc_k[u], nr = a & 255;
      const int cv = (fgen[u] == k ? 0 : c[u]) + (a >> 8);
      c[u] = cv;
      recv[u] += nr;
      if (cv >= p.theta) next_front[atomicAdd(&n_front[(k + 1) & 1], 1)] = u;
    }
    for (int i = THREADS - 1 - tid; i < nfront; i += THREADS) {
      const int v = front[i];
      if (acc_k[v] == 0) c[v] = 0;
    }
    bool fresh = true;
    if (full) {
      REPRO_FOR_PAIRS(n, nf, tid, THREADS,
                      fresh &= repro::update(wa, wb, fgen, k, n, side, u, f,
                                             nbr[u], p.l_c));
    } else {
      const int npr = n_recv[(k + 2) % 3];
      for (int e = (tid + THREADS / 2) % THREADS; e < (nrc + npr) * nf;
           e += THREADS) {
        const int i = e / nf, f = e - i * nf;
        if (i < nrc) {
          const int u = cur[i];
          fresh &= repro::update(wa, wb, fgen, k, n, side, u, f, nbr[u],
                                 p.l_c);
        } else {
          const int u = prev[i - nrc];
          if (acc_k[u] == 0) wb[f * n + u] = wa[f * n + u];
        }
      }
    }
    if (!fresh) *dirty = 1;
    float* tw = wa; wa = wb; wb = tw;
    ++waves;
    __syncthreads();
  }

  // ---- outputs: the slice, and the lattices, each from another of the
  // blocks that own features (each holds the whole cascade's state)
  if (p.out2) {   // two features a store
    REPRO_FOR_PAIRS(n, nf / 2, tid, THREADS,
                    *reinterpret_cast<float2*>(
                        p.w_out + static_cast<size_t>(u) * d + f0 + 2 * f) =
                        make_float2(wa[2 * f * n + u],
                                    wa[(2 * f + 1) * n + u]));
  } else {
    REPRO_FOR_PAIRS(n, nf, tid, THREADS,
                    p.w_out[static_cast<size_t>(u) * d + f0 + f] =
                        wa[f * n + u]);
  }
  const int owners = (d + ds - 1) / ds;
  if (g == 0) {
    const uint16_t* front = fronts + (waves & 1) * n;
    for (int i = tid; i < n_front[waves & 1]; i += THREADS)
      fgen[front[i]] = waves;   // the front left after the last wave
    __syncthreads();
    for (int u = tid; u < n; u += THREADS) p.fired_out[u] = fgen[u] == waves;
    if (tid == 0) {   // every thread counted every front
      p.stats_out[0] = size;
      p.stats_out[1] = waves;
    }
  }
  if (g == 1 % owners)
    for (int u = tid; u < n; u += THREADS) p.c_out[u] = c[u];
  if (g == 2 % owners)
    for (int u = tid; u < n; u += THREADS) p.recv_out[u] = recv[u];
