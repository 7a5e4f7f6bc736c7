// Native scene loader: C++ implementation of the YAML scene schema.
//
// Plays the role of the reference's C++ loader stack (reference:
// src/scene.cpp + yaml-cpp + src/surface.cpp + src/light.cpp) for the
// package's host-side runtime: parses a scene YAML (the subset the scene
// corpus uses: block/flow mappings and sequences, scalars, comments),
// applies the reference's defaults and validation, evaluates the surface
// factories (including the reference's clebsch z3-stays-zero quirk,
// reference: src/surface.cpp:44), and emits flat tables ready to become
// device arrays: [N,20] f64 coefficients, [N,3] f32 colors, [N] f32
// reflection ratios, and a struct-of-arrays light table.
//
// Exposed through a C ABI consumed from Python via ctypes
// (tpu_ray_tracer/native/__init__.py); the Python loader remains the
// reference behavior oracle and the fallback.

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

namespace {

// ---------- minimal YAML subset parser ----------
// Node model: scalar / sequence / mapping, with source line for errors.

struct Node {
    enum Kind { SCALAR, SEQ, MAP } kind = SCALAR;
    std::string scalar;
    std::vector<Node> seq;
    std::vector<std::pair<std::string, Node>> map;
    int line = 0;
    int column = 0;

    const Node* find(const std::string& key) const {
        for (const auto& kv : map)
            if (kv.first == key) return &kv.second;
        return nullptr;
    }
};

struct ParseError {
    std::string message;
};

struct Line {
    int indent;
    std::string text;  // content without indent
    int number;        // 1-based
};

std::vector<Line> split_lines(const std::string& text) {
    std::vector<Line> out;
    std::istringstream stream(text);
    std::string raw;
    int number = 0;
    while (std::getline(stream, raw)) {
        number++;
        // strip comments (naive: '#' not inside quotes; scene corpus uses none)
        bool in_quote = false;
        std::string kept;
        for (char c : raw) {
            if (c == '"' || c == '\'') in_quote = !in_quote;
            if (c == '#' && !in_quote) break;
            kept += c;
        }
        // rstrip
        while (!kept.empty() && isspace((unsigned char)kept.back())) kept.pop_back();
        if (kept.empty()) continue;
        int indent = 0;
        while (indent < (int)kept.size() && kept[indent] == ' ') indent++;
        out.push_back({indent, kept.substr(indent), number});
    }
    return out;
}

std::string strip(const std::string& s) {
    size_t a = s.find_first_not_of(" \t");
    if (a == std::string::npos) return "";
    size_t b = s.find_last_not_of(" \t");
    return s.substr(a, b - a + 1);
}

// Parse a flow value: scalar, [..], or {..}. `src` is the full value text.
Node parse_flow(const std::string& src, int line);

std::vector<std::string> split_top_level(const std::string& body) {
    // split on commas not inside nested brackets
    std::vector<std::string> parts;
    int depth = 0;
    std::string cur;
    for (char c : body) {
        if (c == '[' || c == '{') depth++;
        if (c == ']' || c == '}') depth--;
        if (c == ',' && depth == 0) {
            parts.push_back(strip(cur));
            cur.clear();
        } else {
            cur += c;
        }
    }
    if (!strip(cur).empty()) parts.push_back(strip(cur));
    return parts;
}

Node parse_flow(const std::string& src, int line) {
    Node node;
    node.line = line;
    std::string s = strip(src);
    if (!s.empty() && s.front() == '[') {
        if (s.back() != ']') throw ParseError{"unterminated flow sequence"};
        node.kind = Node::SEQ;
        for (const auto& part : split_top_level(s.substr(1, s.size() - 2)))
            node.seq.push_back(parse_flow(part, line));
        return node;
    }
    if (!s.empty() && s.front() == '{') {
        if (s.back() != '}') throw ParseError{"unterminated flow mapping"};
        node.kind = Node::MAP;
        for (const auto& part : split_top_level(s.substr(1, s.size() - 2))) {
            size_t colon = part.find(':');
            if (colon == std::string::npos)
                throw ParseError{"flow mapping entry missing ':'"};
            node.map.emplace_back(strip(part.substr(0, colon)),
                                  parse_flow(part.substr(colon + 1), line));
        }
        return node;
    }
    node.kind = Node::SCALAR;
    node.scalar = s;
    return node;
}

// Recursive-descent block parser over the line list.
struct BlockParser {
    const std::vector<Line>& lines;
    size_t pos = 0;

    explicit BlockParser(const std::vector<Line>& l) : lines(l) {}

    Node parse_block(int min_indent) {
        Node node;
        if (pos >= lines.size()) return node;
        const Line& first = lines[pos];
        node.line = first.number;
        if (first.text.rfind("- ", 0) == 0 || first.text == "-") {
            node.kind = Node::SEQ;
            int seq_indent = first.indent;
            while (pos < lines.size() && lines[pos].indent == seq_indent &&
                   (lines[pos].text.rfind("- ", 0) == 0 || lines[pos].text == "-")) {
                node.seq.push_back(parse_seq_item(seq_indent));
            }
            return node;
        }
        node.kind = Node::MAP;
        int map_indent = first.indent;
        while (pos < lines.size() && lines[pos].indent == map_indent &&
               lines[pos].indent >= min_indent) {
            const Line& ln = lines[pos];
            if (ln.text.rfind("- ", 0) == 0) break;
            size_t colon = ln.text.find(':');
            if (colon == std::string::npos)
                throw ParseError{"expected 'key: value' at line " +
                                 std::to_string(ln.number)};
            std::string key = strip(ln.text.substr(0, colon));
            std::string rest = strip(ln.text.substr(colon + 1));
            pos++;
            if (!rest.empty()) {
                Node value = parse_flow(rest, ln.number);
                value.line = ln.number;
                node.map.emplace_back(key, value);
            } else {
                // nested block
                if (pos < lines.size() && lines[pos].indent > map_indent) {
                    Node child = parse_block(map_indent + 1);
                    child.line = ln.number;
                    node.map.emplace_back(key, child);
                } else {
                    Node empty;
                    empty.line = ln.number;
                    node.map.emplace_back(key, empty);
                }
            }
        }
        return node;
    }

    Node parse_seq_item(int seq_indent) {
        const Line& ln = lines[pos];
        std::string rest = strip(ln.text.substr(ln.text == "-" ? 1 : 2));
        if (!rest.empty() && (rest.front() == '{' || rest.front() == '[')) {
            pos++;
            Node v = parse_flow(rest, ln.number);
            v.line = ln.number;
            return v;
        }
        // "- key: value" style: treat the remainder as the first map entry,
        // continuation lines are indented deeper than the dash.
        Node item;
        item.kind = Node::MAP;
        item.line = ln.number;
        if (!rest.empty()) {
            size_t colon = rest.find(':');
            if (colon == std::string::npos)
                throw ParseError{"expected mapping after '-' at line " +
                                 std::to_string(ln.number)};
            std::string key = strip(rest.substr(0, colon));
            std::string val = strip(rest.substr(colon + 1));
            pos++;
            if (!val.empty()) {
                Node v = parse_flow(val, ln.number);
                v.line = ln.number;
                item.map.emplace_back(key, v);
            } else if (pos < lines.size() && lines[pos].indent > seq_indent + 2) {
                Node child = parse_block(seq_indent + 2);
                child.line = ln.number;
                item.map.emplace_back(key, child);
            } else {
                item.map.emplace_back(key, Node{});
            }
        } else {
            pos++;
        }
        int item_indent = seq_indent + 2;
        while (pos < lines.size() && lines[pos].indent >= item_indent &&
               lines[pos].text.rfind("- ", 0) != 0) {
            Node more = parse_block(item_indent);
            for (auto& kv : more.map) item.map.push_back(std::move(kv));
            if (more.kind != Node::MAP) break;
        }
        return item;
    }
};

// ---------- typed accessors (reference scene.cpp:41-76 analogues) ----------

double as_double(const Node& n, bool& ok) {
    if (n.kind != Node::SCALAR) { ok = false; return 0; }
    char* end = nullptr;
    double v = strtod(n.scalar.c_str(), &end);
    ok = end && *end == '\0' && !n.scalar.empty();
    return v;
}

long as_uint(const Node& n, bool& ok) {
    if (n.kind != Node::SCALAR) { ok = false; return 0; }
    char* end = nullptr;
    long v = strtol(n.scalar.c_str(), &end, 0);
    ok = end && *end == '\0' && !n.scalar.empty() && v >= 0;
    return v;
}

bool as_vec3(const Node& n, double out[3]) {
    if (n.kind != Node::SEQ || n.seq.size() != 3) return false;
    for (int i = 0; i < 3; i++) {
        bool ok = false;
        out[i] = as_double(n.seq[i], ok);
        if (!ok) return false;
    }
    return true;
}

std::string mark(const Node& n) {
    return "line: " + std::to_string(n.line) + " column: " +
           std::to_string(n.column + 1);
}

[[noreturn]] void fail_undefined(const Node& parent, const char* key) {
    throw ParseError{std::string("Value '") + key + "' undefined, " + mark(parent)};
}

[[noreturn]] void fail_invalid(const Node& n, const char* key) {
    throw ParseError{std::string("Value '") + key + "' is invalid, " + mark(n)};
}

double get_double(const Node& parent, const char* key) {
    const Node* n = parent.find(key);
    if (!n) fail_undefined(parent, key);
    bool ok = false;
    double v = as_double(*n, ok);
    if (!ok) fail_invalid(*n, key);
    return v;
}

long get_uint(const Node& parent, const char* key) {
    const Node* n = parent.find(key);
    if (!n) fail_undefined(parent, key);
    bool ok = false;
    long v = as_uint(*n, ok);
    if (!ok) fail_invalid(*n, key);
    return v;
}

std::string get_string(const Node& parent, const char* key) {
    const Node* n = parent.find(key);
    if (!n) fail_undefined(parent, key);
    if (n->kind != Node::SCALAR) fail_invalid(*n, key);
    return n->scalar;
}

void get_vec3(const Node& parent, const char* key, double out[3]) {
    const Node* n = parent.find(key);
    if (!n) fail_undefined(parent, key);
    if (!as_vec3(*n, out)) fail_invalid(*n, key);
}

// optional with silent fallback (yaml-cpp as<T>(fallback) semantics)
double opt_double(const Node& parent, const char* key, double fallback) {
    const Node* n = parent.find(key);
    if (!n) return fallback;
    bool ok = false;
    double v = as_double(*n, ok);
    return ok ? v : fallback;
}

long opt_uint(const Node& parent, const char* key, long fallback) {
    const Node* n = parent.find(key);
    if (!n) return fallback;
    bool ok = false;
    long v = as_uint(*n, ok);
    return ok ? v : fallback;
}

void opt_vec3(const Node& parent, const char* key, const double fallback[3],
              double out[3]) {
    const Node* n = parent.find(key);
    if (!n || !as_vec3(*n, out)) {
        out[0] = fallback[0]; out[1] = fallback[1]; out[2] = fallback[2];
    }
}

// ---------- validation (reference scene-exception.h) ----------

void validate_positive(const char* what, double v) {
    if (v < 0) {
        std::ostringstream err;
        err << "Negative value for " << what << ": " << v;
        throw ParseError{err.str()};
    }
}

void validate_color(const double c[3]) {
    for (int i = 0; i < 3; i++) {
        if (c[i] < 0.0 || c[i] > 1.0) {
            std::ostringstream err;
            err << "Invalid color: (" << c[0] << ", " << c[1] << ", " << c[2] << ")";
            throw ParseError{err.str()};
        }
    }
}

// ---------- surface factories (reference src/surface.cpp) ----------
// Coefficient order matches include/surface.h:12-14:
//   x3 y3 z3 x2y xy2 x2z xz2 y2z yz2 xyz x2 y2 z2 xy xz yz x y z c
enum {
    X3, Y3, Z3, X2Y, XY2, X2Z, XZ2, Y2Z, YZ2, XYZ,
    X2, Y2, Z2, XY, XZ, YZ, X, Y, Z, C, NCOEF
};

const char* COEF_NAMES[NCOEF] = {
    "x3", "y3", "z3", "x2y", "xy2", "x2z", "xz2", "y2z", "yz2", "xyz",
    "x2", "y2", "z2", "xy", "xz", "yz", "x", "y", "z", "c",
};

void surface_sphere(const double c[3], double r, double* out) {
    validate_positive("sphere radius", r);
    out[X2] = out[Y2] = out[Z2] = 1.0;
    out[X] = -2.0 * c[0];
    out[Y] = -2.0 * c[1];
    out[Z] = -2.0 * c[2];
    out[C] = c[0]*c[0] + c[1]*c[1] + c[2]*c[2] - r * r;
}

void surface_plane(const double o[3], const double n[3], double* out) {
    out[X] = n[0]; out[Y] = n[1]; out[Z] = n[2];
    out[C] = -(o[0]*n[0] + o[1]*n[1] + o[2]*n[2]);
}

void surface_dingdong(const double o[3], double* out) {
    out[X2] = out[Y3] = out[Z2] = 1.0;
    out[Y2] = -1.0 - 3.0 * o[1];
    out[X] = -2.0 * o[0];
    out[Z] = -2.0 * o[2];
    out[Y] = (2.0 + 3.0 * o[1]) * o[1];
    out[C] = o[0]*o[0] + o[2]*o[2] - o[1]*o[1] * (1.0 + o[1]);
}

void surface_clebsch(double* out) {
    // reference quirk: z3 is never assigned (src/surface.cpp:44)
    out[X3] = out[Y3] = 81.0;
    out[X2Y] = out[X2Z] = out[XY2] = out[Y2Z] = out[XZ2] = out[YZ2] = -189.0;
    out[XYZ] = 54.0;
    out[XY] = out[YZ] = out[XZ] = 126.0;
    out[X2] = out[Y2] = out[Z2] = -9.0;
    out[X] = out[Y] = out[Z] = 9.0;
    out[C] = 1.0;
}

void surface_cayley(double* out) {
    out[X2Y] = out[X2Z] = out[XY2] = out[Y2Z] = out[XZ2] = out[YZ2] = -5.0;
    out[XY] = out[YZ] = out[XZ] = 2.0;
}

void parse_surface(const Node& node, double* out) {
    std::memset(out, 0, sizeof(double) * NCOEF);
    std::string type = get_string(node, "type");
    const double zeros[3] = {0, 0, 0};
    const double up[3] = {0, 1, 0};
    if (type == "sphere") {
        double center[3];
        opt_vec3(node, "center", zeros, center);
        surface_sphere(center, opt_double(node, "radius", 1.0), out);
    } else if (type == "plane") {
        double origin[3], normal[3];
        opt_vec3(node, "origin", zeros, origin);
        opt_vec3(node, "normal", up, normal);
        surface_plane(origin, normal, out);
    } else if (type == "dingDong") {
        double origin[3];
        opt_vec3(node, "origin", zeros, origin);
        surface_dingdong(origin, out);
    } else if (type == "clebsch") {
        surface_clebsch(out);
    } else if (type == "cayley") {
        surface_cayley(out);
    } else if (type == "polynomial") {
        const Node* coefs = node.find("coefficients");
        if (!coefs) fail_undefined(node, "coefficients");
        if (coefs->kind != Node::MAP)
            throw ParseError{"Value 'coefficients' must be a mapping, " +
                             mark(*coefs)};
        for (int i = 0; i < NCOEF; i++)
            out[i] = opt_double(*coefs, COEF_NAMES[i], 0.0);
    } else {
        const Node* tn = node.find("type");
        throw ParseError{"Unknown surface type: '" + type + "', " + mark(*tn)};
    }
}

}  // namespace

// ---------- C ABI ----------

extern "C" {

struct TrtScene {
    int ok;
    char error[512];
    int width, height;
    double fov_deg;
    int max_reflections;
    float bg[3];
    int n_objects;
    double* coefs;      // [n_objects * 20]
    float* colors;      // [n_objects * 3]
    float* reflection;  // [n_objects]
    int n_lights;
    int* is_spherical;  // [n_lights]
    double* light_p;    // [n_lights * 3]
    float* light_color; // [n_lights * 3]
};

static TrtScene* make_error(const std::string& msg) {
    auto* s = new TrtScene();
    std::memset(s, 0, sizeof(TrtScene));
    s->ok = 0;
    std::snprintf(s->error, sizeof(s->error), "%s", msg.c_str());
    return s;
}

TrtScene* trt_load_scene(const char* path) {
    std::ifstream file(path);
    if (!file) return make_error(std::string("Cannot read the file ") + path);
    std::stringstream buf;
    buf << file.rdbuf();

    try {
        auto lines = split_lines(buf.str());
        BlockParser parser(lines);
        Node root = parser.parse_block(0);
        if (root.kind != Node::MAP)
            throw ParseError{"scene document must be a mapping"};

        auto* s = new TrtScene();
        std::memset(s, 0, sizeof(TrtScene));
        s->ok = 1;
        s->width = (int)get_uint(root, "width");
        s->height = (int)get_uint(root, "height");
        s->fov_deg = get_double(root, "fov");
        s->max_reflections = (int)opt_uint(root, "max_reflections", 5);
        const double white[3] = {1, 1, 1};
        double bg[3];
        opt_vec3(root, "bg_color", white, bg);
        validate_color(bg);
        for (int i = 0; i < 3; i++) s->bg[i] = (float)bg[i];

        const Node* objects = root.find("objects");
        if (!objects) fail_undefined(root, "objects");
        if (objects->kind != Node::SEQ)
            throw ParseError{"Value 'objects' must be a sequence, " + mark(*objects)};
        const Node* lights = root.find("light_sources");
        if (!lights) fail_undefined(root, "light_sources");
        if (lights->kind != Node::SEQ)
            throw ParseError{"Value 'light_sources' must be a sequence, " +
                             mark(*lights)};

        s->n_objects = (int)objects->seq.size();
        s->coefs = new double[s->n_objects * NCOEF]();
        s->colors = new float[s->n_objects * 3]();
        s->reflection = new float[s->n_objects]();
        for (int i = 0; i < s->n_objects; i++) {
            const Node& node = objects->seq[i];
            parse_surface(node, s->coefs + i * NCOEF);
            double refl = opt_double(node, "reflection_ratio", 0.0);
            validate_positive("object reflection ratio", refl);
            s->reflection[i] = (float)refl;
            double color[3];
            get_vec3(node, "color", color);
            validate_color(color);
            for (int k = 0; k < 3; k++) s->colors[i * 3 + k] = (float)color[k];
        }

        s->n_lights = (int)lights->seq.size();
        s->is_spherical = new int[s->n_lights]();
        s->light_p = new double[s->n_lights * 3]();
        s->light_color = new float[s->n_lights * 3]();
        const double white3[3] = {1, 1, 1};
        for (int i = 0; i < s->n_lights; i++) {
            const Node& node = lights->seq[i];
            std::string type = get_string(node, "type");
            double intensity = opt_double(node, "intensity", 1.0);
            validate_positive("light intensity", intensity);
            double color[3];
            opt_vec3(node, "color", white3, color);
            validate_color(color);
            if (type == "directional") {
                double dir[3];
                get_vec3(node, "direction", dir);
                double len = std::sqrt(dir[0]*dir[0] + dir[1]*dir[1] + dir[2]*dir[2]);
                for (int k = 0; k < 3; k++)
                    s->light_p[i * 3 + k] = -dir[k] / len;
                s->is_spherical[i] = 0;
            } else if (type == "spherical") {
                double pos[3];
                get_vec3(node, "position", pos);
                for (int k = 0; k < 3; k++) s->light_p[i * 3 + k] = pos[k];
                s->is_spherical[i] = 1;
            } else {
                const Node* tn = node.find("type");
                throw ParseError{
                    "Light source type must be 'spherical' or 'directional', " +
                    mark(*tn)};
            }
            for (int k = 0; k < 3; k++)
                s->light_color[i * 3 + k] = (float)(intensity * color[k]);
        }
        return s;
    } catch (const ParseError& e) {
        return make_error(e.message);
    }
}

void trt_free_scene(TrtScene* s) {
    if (!s) return;
    delete[] s->coefs;
    delete[] s->colors;
    delete[] s->reflection;
    delete[] s->is_spherical;
    delete[] s->light_p;
    delete[] s->light_color;
    delete s;
}

}  // extern "C"
