/* Validation-only libavcodec shim: AAC-LC reference decode + encode.
 *
 * NOT part of any decode path — hpfw_jax.io.aac is (to be) a standalone
 * from-spec decoder; this shim exists so tests and the table-recovery
 * tooling can certify it against a real reference implementation
 * (ffmpeg's AAC decoder) and generate real-encoder fixtures (ffmpeg's
 * native AAC-LC encoder), exactly like io/mpeg_ref.py does with
 * libmpg123/lame and io/vorbis_ref.py with libvorbis.
 *
 * Built as a SEPARATE optional shared library (make aacref) so the main
 * libhpfw_native.so never depends on system ffmpeg; the Python wrapper
 * (hpfw_jax/io/aac_ref.py) degrades to available() == False when the
 * build or the libraries are missing.
 *
 * Reference parity note: the C++ reference wraps an Essentia-class audio
 * loader for lossy-codec decode (SURVEY.md §2.1 row 1 — mount empty,
 * recollection); here the codec is reimplemented from spec and the system
 * library is used only as a test oracle.
 */

#include <stdint.h>
#include <string.h>

#include <libavcodec/avcodec.h>
#include <libavutil/channel_layout.h>
#include <libavutil/log.h>
#include <libavutil/samplefmt.h>

/* ---------------------------------------------------------------- decode */

/* Decode an ADTS AAC stream. `out` is caller-allocated interleaved f32 of
 * capacity out_cap floats. Returns samples-per-channel (>=0) or a negative
 * error. sample_rate/channels are filled from the first decoded frame.
 * strict != 0 sets AV_EF_EXPLODE-class error recognition so malformed
 * bitstreams FAIL instead of being concealed — the probe tooling's
 * parse-success/failure signal. */
int hpfw_aacref_decode2(const uint8_t *data, long len, float *out,
                        long out_cap, int *sample_rate, int *channels,
                        int strict) {
  av_log_set_level(AV_LOG_ERROR);
  const AVCodec *codec = avcodec_find_decoder(AV_CODEC_ID_AAC);
  if (!codec) return -1;
  AVCodecContext *ctx = avcodec_alloc_context3(codec);
  AVCodecParserContext *parser = av_parser_init(AV_CODEC_ID_AAC);
  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  long n = 0; /* samples per channel written */
  int ret = -2;
  if (!ctx || !parser || !pkt || !frame) goto done;
  if (strict) {
    av_log_set_level(AV_LOG_QUIET);
    ctx->err_recognition = AV_EF_CRCCHECK | AV_EF_BITSTREAM | AV_EF_BUFFER |
                           AV_EF_EXPLODE;
  }
  if (avcodec_open2(ctx, codec, NULL) < 0) goto done;

  *sample_rate = 0;
  *channels = 0;
  {
    const uint8_t *p = data;
    long remaining = len;
    int flushed = 0;
    while (remaining > 0 || !flushed) {
      if (remaining > 0) {
        uint8_t *obuf = NULL;
        int osize = 0;
        int used = av_parser_parse2(parser, ctx, &obuf, &osize, p,
                                    (int)remaining, AV_NOPTS_VALUE,
                                    AV_NOPTS_VALUE, 0);
        if (used < 0) { ret = -3; goto done; }
        p += used;
        remaining -= used;
        if (osize == 0) continue;
        pkt->data = obuf;
        pkt->size = osize;
        if (avcodec_send_packet(ctx, pkt) < 0) { ret = -4; goto done; }
      } else {
        if (avcodec_send_packet(ctx, NULL) < 0) { ret = -4; goto done; }
        flushed = 1;
      }
      for (;;) {
        int r = avcodec_receive_frame(ctx, frame);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
        if (r < 0) { ret = -5; goto done; }
        int ch = ctx->ch_layout.nb_channels;
        if (!*channels) { *channels = ch; *sample_rate = ctx->sample_rate; }
        if (frame->format != AV_SAMPLE_FMT_FLTP) { ret = -6; goto done; }
        if ((n + frame->nb_samples) * (long)ch > out_cap) { ret = -7; goto done; }
        for (int i = 0; i < frame->nb_samples; i++)
          for (int c = 0; c < ch; c++)
            out[(n + i) * ch + c] = ((const float *)frame->data[c])[i];
        n += frame->nb_samples;
      }
    }
  }
  ret = (int)n;

done:
  av_frame_free(&frame);
  av_packet_free(&pkt);
  if (parser) av_parser_close(parser);
  avcodec_free_context(&ctx);
  return ret;
}

/* Back-compat lenient entry point. */
int hpfw_aacref_decode(const uint8_t *data, long len, float *out,
                       long out_cap, int *sample_rate, int *channels) {
  return hpfw_aacref_decode2(data, len, out, out_cap, sample_rate, channels,
                             0);
}

/* ---------------------------------------------------------------- encode */

static const int kAdtsRates[] = {96000, 88200, 64000, 48000, 44100, 32000,
                                 24000, 22050, 16000, 12000, 11025, 8000};

static int adts_rate_index(int sr) {
  for (int i = 0; i < 12; i++)
    if (kAdtsRates[i] == sr) return i;
  return -1;
}

/* 7-byte ADTS header, no CRC, AAC-LC (profile index 1). */
static void write_adts(uint8_t *h, int sr_idx, int channels, int frame_len) {
  int len = frame_len + 7;
  h[0] = 0xFF;
  h[1] = 0xF1; /* MPEG-4, layer 0, protection_absent=1 */
  h[2] = (uint8_t)((1 << 6) | (sr_idx << 2) | ((channels >> 2) & 1));
  h[3] = (uint8_t)(((channels & 3) << 6) | ((len >> 11) & 3));
  h[4] = (uint8_t)((len >> 3) & 0xFF);
  h[5] = (uint8_t)(((len & 7) << 5) | 0x1F);
  h[6] = 0xFC;
}

/* Encode interleaved f32 PCM with ffmpeg's native AAC-LC encoder into an
 * ADTS stream. Returns output byte length (>=0) or a negative error. */
int hpfw_aacref_encode(const float *pcm, long n, int sample_rate,
                       int channels, int bitrate, uint8_t *out,
                       long out_cap) {
  av_log_set_level(AV_LOG_ERROR);
  int sr_idx = adts_rate_index(sample_rate);
  if (sr_idx < 0 || channels < 1 || channels > 2) return -1;
  const AVCodec *codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  if (!codec) return -1;
  AVCodecContext *ctx = avcodec_alloc_context3(codec);
  AVPacket *pkt = av_packet_alloc();
  AVFrame *frame = av_frame_alloc();
  long written = 0;
  int ret = -2;
  if (!ctx || !pkt || !frame) goto done;
  ctx->sample_rate = sample_rate;
  ctx->sample_fmt = AV_SAMPLE_FMT_FLTP;
  ctx->bit_rate = bitrate;
  av_channel_layout_default(&ctx->ch_layout, channels);
  /* the native encoder is "experimental" below certain rates in some
   * builds; allow it so all nine pipeline rates are encodable */
  ctx->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
  if (avcodec_open2(ctx, codec, NULL) < 0) goto done;

  {
    int fs = ctx->frame_size > 0 ? ctx->frame_size : 1024;
    long pos = 0;
    int flushed = 0;
    while (pos < n || !flushed) {
      if (pos < n) {
        frame->nb_samples = fs;
        frame->format = AV_SAMPLE_FMT_FLTP;
        av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
        if (av_frame_get_buffer(frame, 0) < 0) { ret = -3; goto done; }
        long take = n - pos < fs ? n - pos : fs;
        for (int c = 0; c < channels; c++) {
          float *dst = (float *)frame->data[c];
          for (long i = 0; i < take; i++)
            dst[i] = pcm[(pos + i) * channels + c];
          for (long i = take; i < fs; i++) dst[i] = 0.0f;
        }
        pos += take;
        if (avcodec_send_frame(ctx, frame) < 0) { ret = -4; goto done; }
        av_frame_unref(frame);
      } else {
        if (avcodec_send_frame(ctx, NULL) < 0) { ret = -4; goto done; }
        flushed = 1;
      }
      for (;;) {
        int r = avcodec_receive_packet(ctx, pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
        if (r < 0) { ret = -5; goto done; }
        if (written + pkt->size + 7 > out_cap) { ret = -6; goto done; }
        write_adts(out + written, sr_idx, channels, pkt->size);
        memcpy(out + written + 7, pkt->data, pkt->size);
        written += pkt->size + 7;
        av_packet_unref(pkt);
      }
    }
  }
  ret = written > INT32_MAX ? -7 : (int)written;

done:
  av_frame_free(&frame);
  av_packet_free(&pkt);
  avcodec_free_context(&ctx);
  return ret;
}
