// Minimal hand-declared libtiff 4.x API surface.
//
// The deployment image ships /lib/x86_64-linux-gnu/libtiff.so.6 but no
// development headers, so the (stable, documented) C ABI subset we use is
// declared here. Tag constants are from the public TIFF 6.0 spec.
#pragma once

#include <cstdarg>
#include <cstdint>

extern "C" {

typedef struct tiff TIFF;

TIFF *TIFFOpen(const char *, const char *);
void TIFFClose(TIFF *);

int TIFFGetField(TIFF *, uint32_t, ...);
int TIFFSetField(TIFF *, uint32_t, ...);

int TIFFSetDirectory(TIFF *, uint32_t);
int TIFFSetSubDirectory(TIFF *, uint64_t);
int TIFFReadDirectory(TIFF *);
int TIFFWriteDirectory(TIFF *);
uint32_t TIFFNumberOfDirectories(TIFF *);
uint32_t TIFFCurrentDirectory(TIFF *);
uint64_t TIFFCurrentDirOffset(TIFF *);

int TIFFIsTiled(TIFF *);
int64_t TIFFTileSize(TIFF *);
int64_t TIFFStripSize(TIFF *);
uint32_t TIFFNumberOfStrips(TIFF *);
uint32_t TIFFComputeTile(TIFF *, uint32_t x, uint32_t y, uint32_t z, uint16_t s);
int64_t TIFFReadTile(TIFF *, void *, uint32_t x, uint32_t y, uint32_t z, uint16_t s);
int64_t TIFFReadEncodedStrip(TIFF *, uint32_t strip, void *, int64_t);
int64_t TIFFWriteTile(TIFF *, void *, uint32_t x, uint32_t y, uint32_t z, uint16_t s);
int64_t TIFFWriteEncodedStrip(TIFF *, uint32_t strip, void *, int64_t);

typedef void (*TIFFErrorHandler)(const char *, const char *, va_list);
TIFFErrorHandler TIFFSetErrorHandler(TIFFErrorHandler);
TIFFErrorHandler TIFFSetWarningHandler(TIFFErrorHandler);

}  // extern "C"

// --- tag constants (TIFF 6.0 / libtiff public values) ---
#define TIFFTAG_SUBFILETYPE 254
#define TIFFTAG_IMAGEWIDTH 256
#define TIFFTAG_IMAGELENGTH 257
#define TIFFTAG_BITSPERSAMPLE 258
#define TIFFTAG_COMPRESSION 259
#define TIFFTAG_PHOTOMETRIC 262
#define TIFFTAG_IMAGEDESCRIPTION 270
#define TIFFTAG_SAMPLESPERPIXEL 277
#define TIFFTAG_ROWSPERSTRIP 278
#define TIFFTAG_XRESOLUTION 282
#define TIFFTAG_YRESOLUTION 283
#define TIFFTAG_PLANARCONFIG 284
#define TIFFTAG_RESOLUTIONUNIT 296
#define TIFFTAG_SOFTWARE 305
#define TIFFTAG_TILEWIDTH 322
#define TIFFTAG_TILELENGTH 323
#define TIFFTAG_SUBIFD 330
#define TIFFTAG_SAMPLEFORMAT 339
#define TIFFTAG_JPEGQUALITY 65537
#define TIFFTAG_JPEGCOLORMODE 65538
#define JPEGCOLORMODE_RGB 1

#define COMPRESSION_NONE 1
#define COMPRESSION_LZW 5
#define COMPRESSION_JPEG 7
#define COMPRESSION_ADOBE_DEFLATE 8

#define PHOTOMETRIC_MINISBLACK 1
#define PHOTOMETRIC_RGB 2

#define PLANARCONFIG_CONTIG 1
#define PLANARCONFIG_SEPARATE 2

#define SAMPLEFORMAT_UINT 1
#define SAMPLEFORMAT_INT 2
#define SAMPLEFORMAT_IEEEFP 3

#define FILETYPE_REDUCEDIMAGE 0x1
#define RESUNIT_NONE 1
#define RESUNIT_CENTIMETER 3
