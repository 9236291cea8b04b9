// The Huffman dict table: what the dict kernel (huffman.cu) writes and K4's
// pack_payload front end (pack.cu) reads, one i32 buffer of kTableWords
// words.  ops/huffman.py holds the same layout (TABLE_*, META_*):
//   [0, 256)    code_w: each byte value's canonical code
//   [256, 512)  code_l: its length in bits, 0 for a byte absent
//   [512, 768)  the serialized dict as kDictWords u32 stream words, MSB first
//   [768, 784)  i64 fields: dict bits, out total (dict bits + the payload's),
//               the inner stream's bits (-1 for a refused one), the fallback
//               flag, the bytes K4 codes (0 on the fallback), the error word,
//               the first byte K4 codes (0 from the dict kernel)
#pragma once

namespace ie {

constexpr int kDictWords = 256;  // the dict takes at most 6,093 bits
constexpr int kTableCodeW = 0;
constexpr int kTableCodeL = 256;
constexpr int kTableDict = 512;
constexpr int kTableMeta = 768;  // i32 index of the first i64 field
constexpr int kMetaDictBits = 0;
constexpr int kMetaOutTotal = 1;
constexpr int kMetaInnerBits = 2;
constexpr int kMetaFallback = 3;
constexpr int kMetaNbytes = 4;
constexpr int kMetaError = 5;
constexpr int kMetaFirstByte = 6;
constexpr int kMetaFields = 8;  // 7 used, padded
constexpr int kTableWords = kTableMeta + 2 * kMetaFields;

}  // namespace ie
