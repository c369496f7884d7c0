// Golden-data generator for the JAX rebuild's parity tests.
//
// Textually includes the reference implementation (/root/reference/
// line2Dup.cpp, read-only mount) so its file-static kernels are reachable,
// then replays the bundled demo flows (test.cpp: scale_test/angle_test/
// noise_test input preparation) and dumps:
//   * decoded input images (so image-codec differences can't skew parity)
//   * match results per case as JSON
//   * trained template features (addTemplate / addTemplate_rotate) as JSON
//   * kernel-level intermediates (quantized/spread/response/linearized/
//     similarity) as raw binaries
// Built with -DMIPP_NO_INTRINSICS (scalar reference path — the reference's
// own SIMD-vs-scalar equivalence is its design contract).
//
// This tool is *test infrastructure only*: nothing here ships in the
// framework, and the framework contains no code derived from the reference.

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "line2Dup.cpp"  // reference implementation (via -I/root/reference)
#include "nms.hpp"

using line2Dup::Detector;
using line2Dup::Match;
using line2Dup::Template;

static std::string g_ref = "/root/reference/test/";
static std::string g_out = "goldens/";

static void dump_mat_u8(const cv::Mat& m, const std::string& name) {
    std::string path = g_out + name;
    FILE* f = fopen(path.c_str(), "wb");
    int hdr[3] = {m.rows, m.cols, m.channels()};
    fwrite(hdr, 4, 3, f);
    CV_Assert(m.isContinuous());
    fwrite(m.data, 1, (size_t)m.rows * m.cols * m.channels(), f);
    fclose(f);
}

static void dump_mat_u16(const cv::Mat& m, const std::string& name) {
    std::string path = g_out + name;
    FILE* f = fopen(path.c_str(), "wb");
    int hdr[3] = {m.rows, m.cols, m.channels()};
    fwrite(hdr, 4, 3, f);
    CV_Assert(m.isContinuous() && m.depth() == CV_16U);
    fwrite(m.data, 2, (size_t)m.rows * m.cols * m.channels(), f);
    fclose(f);
}

static void dump_matches_json(const std::vector<Match>& matches,
                              const std::vector<int>& nms_keep,
                              const std::string& name) {
    std::string path = g_out + name;
    FILE* f = fopen(path.c_str(), "w");
    fprintf(f, "{\n  \"matches\": [\n");
    for (size_t i = 0; i < matches.size(); ++i) {
        const Match& m = matches[i];
        fprintf(f,
                "    {\"x\": %d, \"y\": %d, \"similarity\": %.9g, "
                "\"class_id\": \"%s\", \"template_id\": %d}%s\n",
                m.x, m.y, m.similarity, m.class_id.c_str(), m.template_id,
                i + 1 < matches.size() ? "," : "");
    }
    fprintf(f, "  ],\n  \"nms_keep\": [");
    for (size_t i = 0; i < nms_keep.size(); ++i)
        fprintf(f, "%d%s", nms_keep[i], i + 1 < nms_keep.size() ? ", " : "");
    fprintf(f, "]\n}\n");
    fclose(f);
}

static void dump_templates_json(Detector& det, const std::string& class_id,
                                const std::string& name) {
    std::string path = g_out + name;
    FILE* f = fopen(path.c_str(), "w");
    fprintf(f, "{\n  \"class_id\": \"%s\",\n  \"templates\": [\n", class_id.c_str());
    int n = det.numTemplates(class_id);
    for (int tid = 0; tid < n; ++tid) {
        const std::vector<Template>& tp = det.getTemplates(class_id, tid);
        fprintf(f, "    [\n");
        for (size_t l = 0; l < tp.size(); ++l) {
            const Template& t = tp[l];
            fprintf(f,
                    "      {\"width\": %d, \"height\": %d, \"tl_x\": %d, "
                    "\"tl_y\": %d, \"pyramid_level\": %d, \"features\": [",
                    t.width, t.height, t.tl_x, t.tl_y, t.pyramid_level);
            for (size_t i = 0; i < t.features.size(); ++i) {
                const line2Dup::Feature& ft = t.features[i];
                fprintf(f, "[%d, %d, %d]%s", ft.x, ft.y, ft.label,
                        i + 1 < t.features.size() ? ", " : "");
            }
            fprintf(f, "]}%s\n", l + 1 < tp.size() ? "," : "");
        }
        fprintf(f, "    ]%s\n", tid + 1 < n ? "," : "");
    }
    fprintf(f, "  ]\n}\n");
    fclose(f);
}

static cv::Mat crop_stride(const cv::Mat& img, int stride) {
    int n = img.rows / stride;
    int m = img.cols / stride;
    return img(cv::Rect(0, 0, stride * m, stride * n)).clone();
}

// ---------------------------------------------------------------- case 0
static void run_case0() {
    Detector det(150, {4, 8});
    det.readClasses({"circle"}, g_ref + "case0/%s_templ.yaml");
    const char* imgs[4] = {"1.jpg", "2.jpg", "3.png", "4.png"};
    for (int i = 0; i < 4; ++i) {
        cv::Mat test = cv::imread(g_ref + "case0/" + imgs[i]);
        cv::Mat img = crop_stride(test, 32);
        dump_mat_u8(img, std::string("case0_img") + std::to_string(i) + ".bin");
        auto matches = det.match(img, 90, {"circle"});
        dump_matches_json(matches, {},
                          std::string("case0_matches") + std::to_string(i) + ".json");
        printf("case0 img%d: %zu matches\n", i, matches.size());
    }
}

// ---------------------------------------------------------------- case 1
static void run_case1() {
    Detector det(128, {4, 8});
    det.readClasses({"test"}, g_ref + "case1/%s_templ.yaml");
    cv::Mat test = cv::imread(g_ref + "case1/test.png");
    int padding = 250;
    cv::Mat padded(test.rows + 2 * padding, test.cols + 2 * padding,
                   test.type(), cv::Scalar::all(0));
    test.copyTo(padded(cv::Rect(padding, padding, test.cols, test.rows)));
    cv::Mat img = crop_stride(padded, 16);
    dump_mat_u8(img, "case1_img.bin");
    auto matches = det.match(img, 90, {"test"});
    dump_matches_json(matches, {}, "case1_matches.json");
    printf("case1: %zu matches\n", matches.size());
}

// ---------------------------------------------------------------- case 2
static void run_case2() {
    Detector det(30, {4, 8});
    det.readClasses({"test"}, g_ref + "case2/%s_templ.yaml");
    cv::Mat test = cv::imread(g_ref + "case2/test.png");
    cv::Mat img = crop_stride(test, 16);
    dump_mat_u8(img, "case2_img.bin");
    auto matches = det.match(img, 90, {"test"});

    std::vector<cv::Rect> boxes;
    std::vector<float> scores;
    std::vector<int> idxs;
    for (auto& m : matches) {
        auto& templ = det.getTemplates("test", m.template_id);
        boxes.push_back(cv::Rect(m.x, m.y, templ[0].width, templ[0].height));
        scores.push_back(m.similarity);
    }
    cv_dnn::NMSBoxes(boxes, scores, 0, 0.5f, idxs);
    dump_matches_json(matches, idxs, "case2_matches.json");
    printf("case2: %zu matches, %zu after NMS\n", matches.size(), idxs.size());
}

// -------------------------------------------------- case 1 training flow
static void run_case1_train() {
    Detector det(128, {4, 8});
    cv::Mat train = cv::imread(g_ref + "case1/train.png");
    cv::Mat img = train(cv::Rect(130, 110, 270, 270)).clone();
    cv::Mat mask(img.size(), CV_8UC1, cv::Scalar(255));
    int padding = 100;
    cv::Mat pimg(img.rows + 2 * padding, img.cols + 2 * padding, img.type(),
                 cv::Scalar::all(0));
    img.copyTo(pimg(cv::Rect(padding, padding, img.cols, img.rows)));
    cv::Mat pmask(mask.rows + 2 * padding, mask.cols + 2 * padding,
                  mask.type(), cv::Scalar::all(0));
    mask.copyTo(pmask(cv::Rect(padding, padding, img.cols, img.rows)));
    dump_mat_u8(pimg, "case1_train_img.bin");
    dump_mat_u8(pmask, "case1_train_mask.bin");

    int first_id = det.addTemplate(pimg, "test", pmask);
    printf("case1_train first_id=%d\n", first_id);
    for (int a = 45; a < 360; a += 45) {
        det.addTemplate_rotate("test", first_id, (float)a,
                               cv::Point2f(pimg.cols / 2.0f, pimg.rows / 2.0f));
    }
    dump_templates_json(det, "test", "case1_train_templates.json");
}

// -------------------------------------------------- case 0 training flow
static void run_case0_train() {
    Detector det(150, {4, 8});
    cv::Mat img = cv::imread(g_ref + "case0/templ/circle.png");
    dump_mat_u8(img, "case0_train_img.bin");
    shape_based_matching::shapeInfo_producer shapes(img);
    for (int i = 1; i <= 10; ++i) {
        float scale = i / 10.0f;
        auto src = shapes.transform(img, 0, scale);
        cv::Mat m255(img.size(), CV_8UC1, cv::Scalar(255));
        cv::Mat msk = shapes.transform(m255, 0, scale) > 0;
        int id = det.addTemplate(src, "circle", msk, -1.0f, -1.0f, 0, "none", (int)(150 * scale));
        printf("case0_train scale=%.1f id=%d\n", scale, id);
    }
    dump_templates_json(det, "circle", "case0_train_templates.json");
}

// ------------------------------------- jabil-style sweep training flow
// Mirrors createLinemod2DTemplates (test_jabil.cpp:46-118): producer with
// angles {0,90,180,270} x scales {0.9, 1.0, 1.1} — the 1.1 upscale is the
// INTER_LINEAR upscale parity case. A case1 crop stands in for the DB
// fiducial crop (Persistence submodule absent from the mount).
static void run_jabil_train() {
    Detector det(150, {4, 8}, 100.0f, 200.0f);
    cv::Mat train = cv::imread(g_ref + "case1/train.png");
    cv::Mat fid = train(cv::Rect(150, 130, 230, 230)).clone();
    dump_mat_u8(fid, "jabil_fid_img.bin");

    shape_based_matching::shapeInfo_producer fid_shapes(fid, cv::Mat());
    fid_shapes.angle_range = {0.0, 270.0};
    fid_shapes.angle_step = 90.0;
    fid_shapes.scale_range = {0.9f, 1.1f};
    fid_shapes.scale_step = 0.1f;
    fid_shapes.produce_infos();
    for (auto& info : fid_shapes.infos) {
        int id = det.addTemplate(fid_shapes.src_of(info), "17",
                                 fid_shapes.mask_of(info), info.scale,
                                 info.angle, 3, "fid.png");
        printf("jabil_train angle=%g scale=%g id=%d\n", info.angle,
               info.scale, id);
    }
    dump_templates_json(det, "17", "jabil_train_templates.json");
}

// ------------------------------------------------ kernel-level goldens
static void run_kernels() {
    // A 128x128 crop of the padded case1 test image with real edges.
    cv::Mat test = cv::imread(g_ref + "case1/test.png");
    cv::Mat img = test(cv::Rect(96, 96, 128, 128)).clone();
    dump_mat_u8(img, "kern_img.bin");

    line2Dup::ColorGradient modality(30.0f, 63, 60.0f);
    cv::Ptr<line2Dup::ColorGradientPyramid> qp = modality.process(img, cv::Mat());
    cv::Mat quantized;
    qp->quantize(quantized);
    dump_mat_u8(quantized, "kern_quantized.bin");
    dump_mat_u8(qp->angle, "kern_angle.bin");

    for (int T : {4, 8}) {
        cv::Mat spread_q;
        line2Dup::spread(quantized, spread_q, T);
        dump_mat_u8(spread_q, std::string("kern_spread_T") + std::to_string(T) + ".bin");
        std::vector<cv::Mat> resp;
        line2Dup::computeResponseMaps(spread_q, resp);
        for (int o = 0; o < 8; ++o)
            dump_mat_u8(resp[o], "kern_resp_T" + std::to_string(T) + "_o" +
                                     std::to_string(o) + ".bin");
        std::vector<cv::Mat> lms(8);
        for (int o = 0; o < 8; ++o) line2Dup::linearize(resp[o], lms[o], T);
        for (int o = 0; o < 8; ++o)
            dump_mat_u8(lms[o], "kern_lm_T" + std::to_string(T) + "_o" +
                                    std::to_string(o) + ".bin");

        // Similarity vs a synthetic template with features on the crop edges
        Template templ;
        templ.pyramid_level = 0;
        cv::Mat mag = qp->magnitude;
        int count = 0;
        for (int r = 8; r < 120 && count < 20; r += 7) {
            for (int c = 8; c < 120 && count < 20; c += 13) {
                if (quantized.at<uchar>(r, c) > 0) {
                    int q = quantized.at<uchar>(r, c);
                    int lbl = 0;
                    while (!((q >> lbl) & 1)) ++lbl;
                    // width 24 + center (40,40) below keep similarityLocal
                    // reads inside the linear-memory plane, matching the
                    // matchClass border-clamp invariant (line2Dup.cpp:1239)
                    templ.features.push_back(line2Dup::Feature(c % 24, r % 24, lbl));
                    ++count;
                }
            }
        }
        templ.width = 24;
        templ.height = 24;
        FILE* f = fopen((g_out + "kern_templ_T" + std::to_string(T) + ".json").c_str(), "w");
        fprintf(f, "{\"width\": 24, \"height\": 24, \"features\": [");
        for (size_t i = 0; i < templ.features.size(); ++i)
            fprintf(f, "[%d, %d, %d]%s", templ.features[i].x, templ.features[i].y,
                    templ.features[i].label,
                    i + 1 < templ.features.size() ? ", " : "");
        fprintf(f, "]}\n");
        fclose(f);

        cv::Mat sim64, sim;
        line2Dup::similarity_64(lms, templ, sim64, img.size(), T);
        dump_mat_u8(sim64, "kern_sim64_T" + std::to_string(T) + ".bin");
        line2Dup::similarity(lms, templ, sim, img.size(), T);
        dump_mat_u16(sim, "kern_sim_T" + std::to_string(T) + ".bin");
        cv::Mat siml;
        line2Dup::similarityLocal(lms, templ, siml, img.size(), T, cv::Point(40, 40));
        dump_mat_u16(siml, "kern_simlocal_T" + std::to_string(T) + ".bin");
        cv::Mat siml64;
        line2Dup::similarityLocal_64(lms, templ, siml64, img.size(), T, cv::Point(40, 40));
        dump_mat_u8(siml64, "kern_simlocal64_T" + std::to_string(T) + ".bin");
    }
}

int main(int argc, char** argv) {
    if (argc > 1) g_out = argv[1];
    run_kernels();
    run_case1_train();
    run_case0_train();
    run_jabil_train();
    run_case0();
    run_case1();
    run_case2();
    printf("golden generation done -> %s\n", g_out.c_str());
    return 0;
}
