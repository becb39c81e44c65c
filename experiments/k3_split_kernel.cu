// The body of bf16 K3 with S split over d between the two consumers, the
// design the shipped kernel departs from (experiments/k3_variants.py,
// variant split_s, pastes it over the shipped body).  Consumer 0 takes the
// first ceil(nd / 2) chunks of d from one Q/K ring, consumer 1 the rest
// from a second; consumer 1 writes its partial S to a 16 KB float32
// exchange and arrives on named barrier 2; consumer 0 adds it, runs the
// softmax and writes P; both then run P V and P W as in the shipped kernel.
// Block (query tile, value slice, image).
__global__ void __launch_bounds__(NTH, 1)
    attn_fwd_bf16(AttnArgs a, const __grid_constant__ Maps mp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring0 = sm;
  unsigned char* ring1 = sm + RQ * SLOT_QK;
  unsigned char* ring_v = sm + OFF_V;
  float* xs = reinterpret_cast<float*>(sm + OFF_X);
  float* alpha_s = reinterpret_cast<float*>(sm + OFF_ROW);   // [2][T]
  float* linv_s = alpha_s + 2 * T;                             // [T]
  const unsigned f0 = wg::smem_u32(sm + OFF_BAR), e0 = f0 + 8 * RQ;
  const unsigned f1 = e0 + 8 * RQ, e1 = f1 + 8 * RQ;
  const unsigned fv = e1 + 8 * RQ, ev = fv + 8 * RV;
  const unsigned pb = wg::smem_u32(sm + OFF_P), wb = wg::smem_u32(sm + OFF_W);

  const int bi = blockIdx.z, q0 = blockIdx.x * T, c0 = blockIdx.y * SLICE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nkt = (a.m + T - 1) / T, nd = (a.d + T - 1) / T;
  const int split = (nd + 1) / 2;
  const int nv = min(NV, (a.c - c0 + T - 1) / T);
  const int qb = a.q_bs ? bi : 0, kb = a.k_bs ? bi : 0, vb = a.v_bs ? bi : 0;

  if (tid == 0) {
    for (int i = 0; i < RQ; ++i) {
      wg::mbar_init(f0 + 8 * i, 1);
      wg::mbar_init(e0 + 8 * i, 4);
      wg::mbar_init(f1 + 8 * i, 1);
      wg::mbar_init(e1 + 8 * i, 4);
    }
    for (int i = 0; i < RV; ++i) {
      wg::mbar_init(fv + 8 * i, 1);
      wg::mbar_init(ev + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (lane != 0) return;
    if (warp == 8 || warp == 10) {
      const bool first = warp == 8;
      unsigned char* ring = first ? ring0 : ring1;
      const unsigned f = first ? f0 : f1, e = first ? e0 : e1;
      const int t0 = first ? 0 : split, t1 = first ? split : nd;
      for (int j = 0, g = 0; j < nkt; ++j)
        for (int t = t0; t < t1; ++t, ++g) {
          const int s = claim<RQ>(f, e, g, 2 * CB);
          const unsigned dst = wg::smem_u32(ring + s * SLOT_QK);
          wg::tma_load_3d(dst, &mp.q, T * t, q0, qb, f + 8 * s);
          wg::tma_load_3d(dst + CB, &mp.k, T * t, T * j, kb, f + 8 * s);
        }
    } else if (warp == 9) {
      for (int j = 0; j < nkt; ++j) {
        const int s = claim<RV>(fv, ev, j, nv * CB);
        const unsigned dst = wg::smem_u32(ring_v + s * SLOT_V);
        for (int h = 0; h < nv; ++h)
          wg::tma_load_3d(dst + h * CB, &mp.v, c0 + T * h, T * j, vb,
                          fv + 8 * s);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wgi = warp >> 2, wl = warp & 3, tw = tid & 127;
  const int g8 = lane >> 2, tq = lane & 3;
  float acc[NV * 32];
#pragma unroll
  for (int i = 0; i < NV * 32; ++i) acc[i] = 0.f;
  float inv[2];
  unsigned char* ring = wgi == 0 ? ring0 : ring1;
  const unsigned f = wgi == 0 ? f0 : f1, e = wgi == 0 ? e0 : e1;
  const int count = wgi == 0 ? split : nd - split;
  int g = 0;

  float mrow[2] = {NEG, NEG};
  float lrow[2] = {0.f, 0.f};
  for (int j = 0; j < nkt; ++j) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    for (int t = 0; t < count; ++t, ++g) {
      const int slot = g % RQ;
      wg::mbar_wait(f + 8 * slot, (g / RQ) & 1);
      const unsigned b = wg::smem_u32(ring + slot * SLOT_QK);
      wg::fence_acc(s);
      wg::wgmma_fence();
      mma_xyt(s, b, b + CB);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
      wg::fence_acc(s);
      if (t > 0 && lane == 0) wg::mbar_arrive(e + 8 * ((g - 1) % RQ));
    }
    wg::wgmma_wait<0>();
    wg::fence_acc(s);
    if (count > 0 && lane == 0) wg::mbar_arrive(e + 8 * ((g - 1) % RQ));

    if (wgi == 1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) xs[i * 128 + tw] = s[i];
      asm volatile("bar.arrive 2, 256;\n" ::: "memory");
      const int sv = j % RV;
      wg::mbar_wait(fv + 8 * sv, (j / RV) & 1);
      const uint4* y = reinterpret_cast<const uint4*>(ring_v + sv * SLOT_V);
      uint4* w = reinterpret_cast<uint4*>(sm + OFF_W);
      for (int r = 0; r < nv * (CB / 16 / 128); ++r) {
        uint4 x = y[tw + 128 * r];
        x.x = square_bf16x2(x.x);
        x.y = square_bf16x2(x.y);
        x.z = square_bf16x2(x.z);
        x.w = square_bf16x2(x.w);
        w[tw + 128 * r] = x;
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ev + 8 * sv);
      wg::fence_async_shared();
      bar_sync(1, 256);
      const float* al = alpha_s + (j & 1) * T + 16 * wl + g8;
      const float alpha[2] = {al[0], al[8]};
#pragma unroll
      for (int i = 0; i < NV * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      wg::fence_acc(acc);
      wg::wgmma_fence();
      mma_p_slice(acc, pb + (j & 1) * CB, wb);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_acc(acc);
      continue;
    }
    bar_sync(2, 256);
    float tmax[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = T * j + 8 * (i >> 2) + 2 * tq + (i & 1);
      s[i] = key < a.m ? (s[i] + xs[i * 128 + tw]) * LOG2E : NEG;
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float mnew = fmaxf(mrow[h], tmax[h]);
      alpha[h] = exp2f(mrow[h] - mnew);
      mrow[h] = mnew;
    }
    unsigned char* P = sm + OFF_P + (j & 1) * CB;
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const float p0 = exp2f(s[i] - mrow[h]);
      const float p1 = exp2f(s[i + 1] - mrow[h]);
      ls[h] += p0 + p1;
      store_p(P, wl, g8, tq, i >> 2, h, p0, p1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lrow[h] = lrow[h] * alpha[h] + ls[h];
      if (tq == 0) alpha_s[(j & 1) * T + 16 * wl + g8 + 8 * h] = alpha[h];
    }
    wg::fence_async_shared();
    bar_sync(1, 256);
#pragma unroll
    for (int i = 0; i < NV * 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
    const int sv = j % RV;
    wg::mbar_wait(fv + 8 * sv, (j / RV) & 1);
    wg::fence_acc(acc);
    wg::wgmma_fence();
    mma_p_slice(acc, pb + (j & 1) * CB, wg::smem_u32(ring_v + sv * SLOT_V));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);
    if (lane == 0) wg::mbar_arrive(ev + 8 * sv);
  }
  if (wgi == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = lrow[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[h] = 1.f / l;
      const int r = 16 * wl + g8 + 8 * h;
      if (tq == 0) {
        linv_s[r] = inv[h];
        if (blockIdx.y == 0 && q0 + r < a.n)
          a.lse[(size_t)bi * a.n + q0 + r] = mrow[h] * LN2 + logf(l);
      }
    }
    bar_sync(1, 256);
    store_slice(a.m1, acc, inv, a, bi, q0, c0, wl, g8, tq);
  } else {
    bar_sync(1, 256);
    inv[0] = linv_s[16 * wl + g8];
    inv[1] = linv_s[16 * wl + g8 + 8];
    store_slice(a.m2, acc, inv, a, bi, q0, c0, wl, g8, tq);
  }
}

