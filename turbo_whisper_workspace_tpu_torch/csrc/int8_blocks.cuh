// Helpers shared by the s8×s8 kernels (cross_attention_s8.cu,
// s8_matmul.cu, s8g4_matmul.cu): the 4x4 byte-block transpose that turns
// four row-major loads into the words dp4a and the int8 mma want, and
// the int8 tensor-core product.
#pragma once

#include <cstdint>

// r[i]: 4 bytes of row i (byte j = column j) → t[j]: the 4 rows' bytes
// of column j (byte i = row i), the order dp4a and mma pair them in
__device__ __forceinline__ void transpose4x4(const unsigned r[4], unsigned t[4]) {
    const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140);
    const unsigned hi01 = __byte_perm(r[0], r[1], 0x7362);
    const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140);
    const unsigned hi23 = __byte_perm(r[2], r[3], 0x7362);
    t[0] = __byte_perm(lo01, lo23, 0x5410);
    t[1] = __byte_perm(lo01, lo23, 0x7632);
    t[2] = __byte_perm(hi01, hi23, 0x5410);
    t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// 4 bytes at p (4-byte aligned) when `valid`, else zeros
__device__ __forceinline__ unsigned load4(const int8_t* p, bool valid) {
    return valid ? *reinterpret_cast<const unsigned*>(p) : 0u;
}

// c (16x8 s32) += a (16x32 s8, row-major) · b (32x8 s8, K-major), the
// m16n8k32 fragments: lane (g = lane/4, t = lane%4) holds a = rows g and
// g + 8 at k 4t..4t+3 and 16+4t..16+4t+3; b = column g at the same k;
// c = rows g, g + 8 at columns 2t, 2t + 1
__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4], unsigned b0,
                                       unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lane (g, t)'s A fragment of an (m, k) int8 matrix: rows m0 + g and
// m0 + g + 8, columns k0 + 4t.. and k0 + 16 + 4t..; rows ≥ m and columns
// ≥ k read as zeros (k a multiple of 4)
__device__ __forceinline__ void load_a(const int8_t* x, int m, int k, int m0, int k0,
                                       int g, int t, unsigned a[4]) {
    const int r_lo = m0 + g;
    const int r_hi = r_lo + 8;
    const int c_lo = k0 + 4 * t;
    const int c_hi = c_lo + 16;
    a[0] = load4(x + (long long)r_lo * k + c_lo, r_lo < m && c_lo < k);
    a[1] = load4(x + (long long)r_hi * k + c_lo, r_hi < m && c_lo < k);
    a[2] = load4(x + (long long)r_lo * k + c_hi, r_lo < m && c_hi < k);
    a[3] = load4(x + (long long)r_hi * k + c_hi, r_hi < m && c_hi < k);
}

// lane (g, t)'s B fragments of four n8 tiles of a row-major (rows, n)
// int8 matrix at rows r0..r0+31: two 4x4 byte blocks (rows r0 + 4t..
// and r0 + 16 + 4t.., columns n0 + 4g..n0 + 4g + 3, one 32-bit load a
// row), transposed. Tile j's column g is the matrix's column n0 + 4g + j:
// the 32 columns of the tiles are a permutation of n0..n0+31, undone
// where the results are written. Rows ≥ rows and columns ≥ n read as
// zeros (n a multiple of 4).
__device__ __forceinline__ void load_b(const int8_t* w, int rows, int n, int n0, int r0,
                                       int g, int t, unsigned b[4][2]) {
    const int col = n0 + 4 * g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * h + 4 * t;
        unsigned rows4[4], cols4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            rows4[i] = load4(w + (long long)(r + i) * n + col, col < n && r + i < rows);
        transpose4x4(rows4, cols4);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j][h] = cols4[j];
    }
}

// the real column (offset from n0) of tile j's accumulator c[e] column:
// tile column 2t + (e & 1) stands for column 4·(2t + (e & 1)) + j
__device__ __forceinline__ int acc_column(int j, int e, int t) {
    return 8 * t + 4 * (e & 1) + j;
}
