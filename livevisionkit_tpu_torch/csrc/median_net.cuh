// Median-selection networks of the deblocker's kernels (csrc/deblock.cu).
// Generated by livevisionkit_tpu_torch/ops/cuda_kernels/median_net.py: edit
// that module and regenerate, not this file.
#pragma once

namespace lvk_median {

// A compare-exchange of wires a < b: both results, the minimum alone, the
// maximum alone.
#define LVK_X(a, b) { const float lo = fminf(v[a], v[b]); v[b] = fmaxf(v[a], v[b]); v[a] = lo; }
#define LVK_LO(a, b) v[a] = fminf(v[a], v[b]);
#define LVK_HI(a, b) v[b] = fmaxf(v[a], v[b]);

template <int N>
struct Net;

// 3 x 3: 22 exchanges, 36 min/max operations.
template <>
struct Net<9> {
  __device__ __forceinline__ static void run(float (&v)[9]) {
    LVK_X(0, 8); LVK_X(0, 4); LVK_X(1, 5); LVK_X(2, 6); LVK_X(3, 7); LVK_X(4, 8);
    LVK_X(0, 2); LVK_X(1, 3); LVK_X(4, 6); LVK_X(5, 7); LVK_X(2, 8); LVK_X(2, 4);
    LVK_X(3, 5); LVK_X(6, 8); LVK_HI(0, 1); LVK_HI(2, 3); LVK_LO(4, 5); LVK_LO(6, 7);
    LVK_LO(1, 8); LVK_HI(1, 4); LVK_LO(3, 6); LVK_HI(3, 4);
  }
};

// 5 x 5: 113 exchanges, 202 min/max operations.
template <>
struct Net<25> {
  __device__ __forceinline__ static void run(float (&v)[25]) {
    LVK_X(0, 16); LVK_X(1, 17); LVK_X(2, 18); LVK_X(3, 19); LVK_X(4, 20); LVK_X(5, 21);
    LVK_X(6, 22); LVK_X(7, 23); LVK_X(8, 24); LVK_X(0, 8); LVK_X(1, 9); LVK_X(2, 10);
    LVK_X(3, 11); LVK_X(4, 12); LVK_X(5, 13); LVK_X(6, 14); LVK_X(7, 15); LVK_X(16, 24);
    LVK_X(8, 16); LVK_X(9, 17); LVK_X(10, 18); LVK_X(11, 19); LVK_X(12, 20); LVK_X(13, 21);
    LVK_X(14, 22); LVK_X(15, 23); LVK_X(0, 4); LVK_X(1, 5); LVK_X(2, 6); LVK_X(3, 7);
    LVK_X(8, 12); LVK_X(9, 13); LVK_X(10, 14); LVK_X(11, 15); LVK_X(16, 20); LVK_X(17, 21);
    LVK_X(18, 22); LVK_X(19, 23); LVK_X(4, 16); LVK_X(5, 17); LVK_X(6, 18); LVK_X(7, 19);
    LVK_X(12, 24); LVK_X(4, 8); LVK_X(5, 9); LVK_X(6, 10); LVK_X(7, 11); LVK_X(12, 16);
    LVK_X(13, 17); LVK_X(14, 18); LVK_X(15, 19); LVK_X(20, 24); LVK_X(0, 2); LVK_X(1, 3);
    LVK_X(4, 6); LVK_X(5, 7); LVK_X(8, 10); LVK_X(9, 11); LVK_X(12, 14); LVK_X(13, 15);
    LVK_X(16, 18); LVK_X(17, 19); LVK_X(20, 22); LVK_X(21, 23); LVK_X(2, 16); LVK_X(3, 17);
    LVK_X(6, 20); LVK_X(7, 21); LVK_X(10, 24); LVK_X(2, 8); LVK_X(3, 9); LVK_X(6, 12);
    LVK_X(7, 13); LVK_X(10, 16); LVK_X(11, 17); LVK_X(14, 20); LVK_X(15, 21); LVK_X(18, 24);
    LVK_X(2, 4); LVK_X(3, 5); LVK_X(6, 8); LVK_X(7, 9); LVK_X(10, 12); LVK_X(11, 13);
    LVK_X(14, 16); LVK_X(15, 17); LVK_X(18, 20); LVK_X(19, 21); LVK_X(22, 24); LVK_HI(0, 1);
    LVK_HI(2, 3); LVK_HI(4, 5); LVK_HI(6, 7); LVK_HI(8, 9); LVK_HI(10, 11); LVK_LO(12, 13);
    LVK_LO(14, 15); LVK_LO(16, 17); LVK_LO(18, 19); LVK_LO(20, 21); LVK_LO(22, 23); LVK_HI(1, 16);
    LVK_HI(3, 18); LVK_LO(5, 20); LVK_LO(7, 22); LVK_LO(9, 24); LVK_HI(5, 12); LVK_HI(7, 14);
    LVK_LO(9, 16); LVK_LO(11, 18); LVK_HI(9, 12); LVK_LO(11, 14); LVK_HI(11, 12);
  }
};

// 7 x 7: 313 exchanges, 578 min/max operations.
template <>
struct Net<49> {
  __device__ __forceinline__ static void run(float (&v)[49]) {
    LVK_X(0, 32); LVK_X(1, 33); LVK_X(2, 34); LVK_X(3, 35); LVK_X(4, 36); LVK_X(5, 37);
    LVK_X(6, 38); LVK_X(7, 39); LVK_X(8, 40); LVK_X(9, 41); LVK_X(10, 42); LVK_X(11, 43);
    LVK_X(12, 44); LVK_X(13, 45); LVK_X(14, 46); LVK_X(15, 47); LVK_X(16, 48); LVK_X(0, 16);
    LVK_X(1, 17); LVK_X(2, 18); LVK_X(3, 19); LVK_X(4, 20); LVK_X(5, 21); LVK_X(6, 22);
    LVK_X(7, 23); LVK_X(8, 24); LVK_X(9, 25); LVK_X(10, 26); LVK_X(11, 27); LVK_X(12, 28);
    LVK_X(13, 29); LVK_X(14, 30); LVK_X(15, 31); LVK_X(32, 48); LVK_X(16, 32); LVK_X(17, 33);
    LVK_X(18, 34); LVK_X(19, 35); LVK_X(20, 36); LVK_X(21, 37); LVK_X(22, 38); LVK_X(23, 39);
    LVK_X(24, 40); LVK_X(25, 41); LVK_X(26, 42); LVK_X(27, 43); LVK_X(28, 44); LVK_X(29, 45);
    LVK_X(30, 46); LVK_X(31, 47); LVK_X(0, 8); LVK_X(1, 9); LVK_X(2, 10); LVK_X(3, 11);
    LVK_X(4, 12); LVK_X(5, 13); LVK_X(6, 14); LVK_X(7, 15); LVK_X(16, 24); LVK_X(17, 25);
    LVK_X(18, 26); LVK_X(19, 27); LVK_X(20, 28); LVK_X(21, 29); LVK_X(22, 30); LVK_X(23, 31);
    LVK_X(32, 40); LVK_X(33, 41); LVK_X(34, 42); LVK_X(35, 43); LVK_X(36, 44); LVK_X(37, 45);
    LVK_X(38, 46); LVK_X(39, 47); LVK_X(8, 32); LVK_X(9, 33); LVK_X(10, 34); LVK_X(11, 35);
    LVK_X(12, 36); LVK_X(13, 37); LVK_X(14, 38); LVK_X(15, 39); LVK_X(24, 48); LVK_X(8, 16);
    LVK_X(9, 17); LVK_X(10, 18); LVK_X(11, 19); LVK_X(12, 20); LVK_X(13, 21); LVK_X(14, 22);
    LVK_X(15, 23); LVK_X(24, 32); LVK_X(25, 33); LVK_X(26, 34); LVK_X(27, 35); LVK_X(28, 36);
    LVK_X(29, 37); LVK_X(30, 38); LVK_X(31, 39); LVK_X(40, 48); LVK_X(0, 4); LVK_X(1, 5);
    LVK_X(2, 6); LVK_X(3, 7); LVK_X(8, 12); LVK_X(9, 13); LVK_X(10, 14); LVK_X(11, 15);
    LVK_X(16, 20); LVK_X(17, 21); LVK_X(18, 22); LVK_X(19, 23); LVK_X(24, 28); LVK_X(25, 29);
    LVK_X(26, 30); LVK_X(27, 31); LVK_X(32, 36); LVK_X(33, 37); LVK_X(34, 38); LVK_X(35, 39);
    LVK_X(40, 44); LVK_X(41, 45); LVK_X(42, 46); LVK_X(43, 47); LVK_X(4, 32); LVK_X(5, 33);
    LVK_X(6, 34); LVK_X(7, 35); LVK_X(12, 40); LVK_X(13, 41); LVK_X(14, 42); LVK_X(15, 43);
    LVK_X(20, 48); LVK_X(4, 16); LVK_X(5, 17); LVK_X(6, 18); LVK_X(7, 19); LVK_X(12, 24);
    LVK_X(13, 25); LVK_X(14, 26); LVK_X(15, 27); LVK_X(20, 32); LVK_X(21, 33); LVK_X(22, 34);
    LVK_X(23, 35); LVK_X(28, 40); LVK_X(29, 41); LVK_X(30, 42); LVK_X(31, 43); LVK_X(36, 48);
    LVK_X(4, 8); LVK_X(5, 9); LVK_X(6, 10); LVK_X(7, 11); LVK_X(12, 16); LVK_X(13, 17);
    LVK_X(14, 18); LVK_X(15, 19); LVK_X(20, 24); LVK_X(21, 25); LVK_X(22, 26); LVK_X(23, 27);
    LVK_X(28, 32); LVK_X(29, 33); LVK_X(30, 34); LVK_X(31, 35); LVK_X(36, 40); LVK_X(37, 41);
    LVK_X(38, 42); LVK_X(39, 43); LVK_X(44, 48); LVK_X(0, 2); LVK_X(1, 3); LVK_X(4, 6);
    LVK_X(5, 7); LVK_X(8, 10); LVK_X(9, 11); LVK_X(12, 14); LVK_X(13, 15); LVK_X(16, 18);
    LVK_X(17, 19); LVK_X(20, 22); LVK_X(21, 23); LVK_X(24, 26); LVK_X(25, 27); LVK_X(28, 30);
    LVK_X(29, 31); LVK_X(32, 34); LVK_X(33, 35); LVK_X(36, 38); LVK_X(37, 39); LVK_X(40, 42);
    LVK_X(41, 43); LVK_X(44, 46); LVK_X(45, 47); LVK_X(2, 32); LVK_X(3, 33); LVK_X(6, 36);
    LVK_X(7, 37); LVK_X(10, 40); LVK_X(11, 41); LVK_X(14, 44); LVK_X(15, 45); LVK_X(18, 48);
    LVK_X(2, 16); LVK_X(3, 17); LVK_X(6, 20); LVK_X(7, 21); LVK_X(10, 24); LVK_X(11, 25);
    LVK_X(14, 28); LVK_X(15, 29); LVK_X(18, 32); LVK_X(19, 33); LVK_X(22, 36); LVK_X(23, 37);
    LVK_X(26, 40); LVK_X(27, 41); LVK_X(30, 44); LVK_X(31, 45); LVK_X(34, 48); LVK_X(2, 8);
    LVK_X(3, 9); LVK_X(6, 12); LVK_X(7, 13); LVK_X(10, 16); LVK_X(11, 17); LVK_X(14, 20);
    LVK_X(15, 21); LVK_X(18, 24); LVK_X(19, 25); LVK_X(22, 28); LVK_X(23, 29); LVK_X(26, 32);
    LVK_X(27, 33); LVK_X(30, 36); LVK_X(31, 37); LVK_X(34, 40); LVK_X(35, 41); LVK_X(38, 44);
    LVK_X(39, 45); LVK_X(42, 48); LVK_X(2, 4); LVK_X(3, 5); LVK_X(6, 8); LVK_X(7, 9);
    LVK_X(10, 12); LVK_X(11, 13); LVK_X(14, 16); LVK_X(15, 17); LVK_X(18, 20); LVK_X(19, 21);
    LVK_X(22, 24); LVK_X(23, 25); LVK_X(26, 28); LVK_X(27, 29); LVK_X(30, 32); LVK_X(31, 33);
    LVK_X(34, 36); LVK_X(35, 37); LVK_X(38, 40); LVK_X(39, 41); LVK_X(42, 44); LVK_X(43, 45);
    LVK_X(46, 48); LVK_HI(0, 1); LVK_HI(2, 3); LVK_HI(4, 5); LVK_HI(6, 7); LVK_HI(8, 9);
    LVK_HI(10, 11); LVK_HI(12, 13); LVK_HI(14, 15); LVK_HI(16, 17); LVK_HI(18, 19); LVK_HI(20, 21);
    LVK_HI(22, 23); LVK_LO(24, 25); LVK_LO(26, 27); LVK_LO(28, 29); LVK_LO(30, 31); LVK_LO(32, 33);
    LVK_LO(34, 35); LVK_LO(36, 37); LVK_LO(38, 39); LVK_LO(40, 41); LVK_LO(42, 43); LVK_LO(44, 45);
    LVK_LO(46, 47); LVK_HI(1, 32); LVK_HI(3, 34); LVK_HI(5, 36); LVK_HI(7, 38); LVK_LO(9, 40);
    LVK_LO(11, 42); LVK_LO(13, 44); LVK_LO(15, 46); LVK_LO(17, 48); LVK_HI(9, 24); LVK_HI(11, 26);
    LVK_HI(13, 28); LVK_HI(15, 30); LVK_LO(17, 32); LVK_LO(19, 34); LVK_LO(21, 36); LVK_LO(23, 38);
    LVK_HI(17, 24); LVK_HI(19, 26); LVK_LO(21, 28); LVK_LO(23, 30); LVK_HI(21, 24); LVK_LO(23, 26);
    LVK_HI(23, 24);
  }
};

#undef LVK_X
#undef LVK_LO
#undef LVK_HI

}  // namespace lvk_median
