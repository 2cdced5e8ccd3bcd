// Batcher odd-even mergesort comparator lists for the frontier kernels
// (csrc/frontier_traverse.cu): the pairs of ops/frontier.batcher_oem(n),
// the JAX package's pallas_frontier._batcher_oem, in the same order.
// tests/test_torch_frontier.py checks this file against that list, so
// the kernel and its plain version run the same network (it is not
// stable: equal keys keep no fixed order unless both run it alike).

#pragma once

// 63 comparators.
#define VKPT_BATCHER16(CS) \
  CS(0, 1) CS(2, 3) CS(4, 5) CS(6, 7) CS(8, 9) CS(10, 11) CS(12, 13) \
  CS(14, 15) CS(0, 2) CS(1, 3) CS(4, 6) CS(5, 7) CS(8, 10) CS(9, 11) \
  CS(12, 14) CS(13, 15) CS(1, 2) CS(5, 6) CS(9, 10) CS(13, 14) CS(0, 4) \
  CS(1, 5) CS(2, 6) CS(3, 7) CS(8, 12) CS(9, 13) CS(10, 14) CS(11, 15) \
  CS(2, 4) CS(3, 5) CS(10, 12) CS(11, 13) CS(1, 2) CS(3, 4) CS(5, 6) \
  CS(9, 10) CS(11, 12) CS(13, 14) CS(0, 8) CS(1, 9) CS(2, 10) CS(3, 11) \
  CS(4, 12) CS(5, 13) CS(6, 14) CS(7, 15) CS(4, 8) CS(5, 9) CS(6, 10) \
  CS(7, 11) CS(2, 4) CS(3, 5) CS(6, 8) CS(7, 9) CS(10, 12) CS(11, 13) \
  CS(1, 2) CS(3, 4) CS(5, 6) CS(7, 8) CS(9, 10) CS(11, 12) CS(13, 14)

// 191 comparators.
#define VKPT_BATCHER32(CS) \
  CS(0, 1) CS(2, 3) CS(4, 5) CS(6, 7) CS(8, 9) CS(10, 11) CS(12, 13) \
  CS(14, 15) CS(16, 17) CS(18, 19) CS(20, 21) CS(22, 23) CS(24, 25) \
  CS(26, 27) CS(28, 29) CS(30, 31) CS(0, 2) CS(1, 3) CS(4, 6) CS(5, 7) \
  CS(8, 10) CS(9, 11) CS(12, 14) CS(13, 15) CS(16, 18) CS(17, 19) \
  CS(20, 22) CS(21, 23) CS(24, 26) CS(25, 27) CS(28, 30) CS(29, 31) \
  CS(1, 2) CS(5, 6) CS(9, 10) CS(13, 14) CS(17, 18) CS(21, 22) CS(25, 26) \
  CS(29, 30) CS(0, 4) CS(1, 5) CS(2, 6) CS(3, 7) CS(8, 12) CS(9, 13) \
  CS(10, 14) CS(11, 15) CS(16, 20) CS(17, 21) CS(18, 22) CS(19, 23) \
  CS(24, 28) CS(25, 29) CS(26, 30) CS(27, 31) CS(2, 4) CS(3, 5) CS(10, 12) \
  CS(11, 13) CS(18, 20) CS(19, 21) CS(26, 28) CS(27, 29) CS(1, 2) CS(3, 4) \
  CS(5, 6) CS(9, 10) CS(11, 12) CS(13, 14) CS(17, 18) CS(19, 20) CS(21, 22) \
  CS(25, 26) CS(27, 28) CS(29, 30) CS(0, 8) CS(1, 9) CS(2, 10) CS(3, 11) \
  CS(4, 12) CS(5, 13) CS(6, 14) CS(7, 15) CS(16, 24) CS(17, 25) CS(18, 26) \
  CS(19, 27) CS(20, 28) CS(21, 29) CS(22, 30) CS(23, 31) CS(4, 8) CS(5, 9) \
  CS(6, 10) CS(7, 11) CS(20, 24) CS(21, 25) CS(22, 26) CS(23, 27) CS(2, 4) \
  CS(3, 5) CS(6, 8) CS(7, 9) CS(10, 12) CS(11, 13) CS(18, 20) CS(19, 21) \
  CS(22, 24) CS(23, 25) CS(26, 28) CS(27, 29) CS(1, 2) CS(3, 4) CS(5, 6) \
  CS(7, 8) CS(9, 10) CS(11, 12) CS(13, 14) CS(17, 18) CS(19, 20) CS(21, 22) \
  CS(23, 24) CS(25, 26) CS(27, 28) CS(29, 30) CS(0, 16) CS(1, 17) CS(2, 18) \
  CS(3, 19) CS(4, 20) CS(5, 21) CS(6, 22) CS(7, 23) CS(8, 24) CS(9, 25) \
  CS(10, 26) CS(11, 27) CS(12, 28) CS(13, 29) CS(14, 30) CS(15, 31) \
  CS(8, 16) CS(9, 17) CS(10, 18) CS(11, 19) CS(12, 20) CS(13, 21) \
  CS(14, 22) CS(15, 23) CS(4, 8) CS(5, 9) CS(6, 10) CS(7, 11) CS(12, 16) \
  CS(13, 17) CS(14, 18) CS(15, 19) CS(20, 24) CS(21, 25) CS(22, 26) \
  CS(23, 27) CS(2, 4) CS(3, 5) CS(6, 8) CS(7, 9) CS(10, 12) CS(11, 13) \
  CS(14, 16) CS(15, 17) CS(18, 20) CS(19, 21) CS(22, 24) CS(23, 25) \
  CS(26, 28) CS(27, 29) CS(1, 2) CS(3, 4) CS(5, 6) CS(7, 8) CS(9, 10) \
  CS(11, 12) CS(13, 14) CS(15, 16) CS(17, 18) CS(19, 20) CS(21, 22) \
  CS(23, 24) CS(25, 26) CS(27, 28) CS(29, 30)
