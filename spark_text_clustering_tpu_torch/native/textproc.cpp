// Native host-side text preprocessing: the PyTorch port's own copy of the
// JAX package's native/textproc.cpp, built by
// spark_text_clustering_tpu_torch/utils/native.py.
//
// C++ port of utils/textproc.py — the map side of the reference's
// BuildTFIDFVector (LDAClustering.scala:113-139): lemmatize (CoreNLP
// getLemmaText equivalent, :293-309) -> clean (:283-284) -> tokenize
// (OpenNLP SimpleTokenizer, :133-135) -> stop-filter -> Porter stem
// (NLTK ORIGINAL_ALGORITHM mode, to_lowercase=False).
//
// The reference's preprocessing hot spot is CPU string work (SURVEY.md §3.2
// "CPU hot spot"); this library is the native-runtime equivalent of the
// JVM NLP stack, called from Python via ctypes (GIL released during calls,
// so documents preprocess in parallel across host cores).
//
// Parity contract: given the same UTF-8 text, stc_preprocess must emit the
// IDENTICAL token sequence as textproc.preprocess_document.  All string
// logic therefore operates on Unicode code points (like Python str), never
// raw bytes.  tests/test_torch_cli.py holds this copy against the JAX
// package's Python path, token for token.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "nnp_suffix_table.h"
#include "unicode_tables.h"

namespace {

using std::string;
using std::vector;
using u32 = uint32_t;
using U32s = vector<u32>;

// ---------------------------------------------------------------------------
// UTF-8 <-> code points
// ---------------------------------------------------------------------------
U32s decode_utf8(const char* s, size_t n) {
  U32s out;
  out.reserve(n);
  size_t i = 0;
  while (i < n) {
    unsigned char c = (unsigned char)s[i];
    u32 cp;
    size_t len;
    if (c < 0x80) {
      cp = c;
      len = 1;
    } else if ((c >> 5) == 0x6) {
      cp = c & 0x1F;
      len = 2;
    } else if ((c >> 4) == 0xE) {
      cp = c & 0x0F;
      len = 3;
    } else if ((c >> 3) == 0x1E) {
      cp = c & 0x07;
      len = 4;
    } else {  // invalid lead byte: emit replacement, resync
      out.push_back(0xFFFD);
      i += 1;
      continue;
    }
    if (i + len > n) {
      out.push_back(0xFFFD);
      break;
    }
    bool ok = true;
    for (size_t k = 1; k < len; ++k) {
      unsigned char cc = (unsigned char)s[i + k];
      if ((cc >> 6) != 0x2) {
        ok = false;
        break;
      }
      cp = (cp << 6) | (cc & 0x3F);
    }
    if (!ok) {
      out.push_back(0xFFFD);
      i += 1;
      continue;
    }
    out.push_back(cp);
    i += len;
  }
  return out;
}

void encode_utf8(u32 cp, string& out) {
  if (cp < 0x80) {
    out += (char)cp;
  } else if (cp < 0x800) {
    out += (char)(0xC0 | (cp >> 6));
    out += (char)(0x80 | (cp & 0x3F));
  } else if (cp < 0x10000) {
    out += (char)(0xE0 | (cp >> 12));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  } else {
    out += (char)(0xF0 | (cp >> 18));
    out += (char)(0x80 | ((cp >> 12) & 0x3F));
    out += (char)(0x80 | ((cp >> 6) & 0x3F));
    out += (char)(0x80 | (cp & 0x3F));
  }
}

string encode_utf8(const U32s& cps) {
  string out;
  out.reserve(cps.size() * 2);
  for (u32 cp : cps) encode_utf8(cp, out);
  return out;
}

// ---------------------------------------------------------------------------
// Character classes — binary search over tables GENERATED from CPython's
// own re-module classification (native/gen_unicode_tables.py), so the
// tokenizer splits text at exactly the same boundaries as the Python path
// for every script, not just the corpus languages.
// ---------------------------------------------------------------------------
bool in_ranges(u32 c, const uint32_t (*ranges)[2], size_t n) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (c < ranges[mid][0]) {
      hi = mid;
    } else if (c > ranges[mid][1]) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}

// what [^\W\d_] matches (letters + numeric letters Nl/No)
bool is_letter(u32 c) {
  if (c < 0x80)
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
  return in_ranges(c, kLetterRanges, kLetterRanges_len);
}

// what \d matches (Unicode decimal digits, category Nd)
bool is_digit(u32 c) {
  if (c < 0x80) return c >= '0' && c <= '9';
  return in_ranges(c, kDigitRanges, kDigitRanges_len);
}

// what \s matches
bool is_space(u32 c) {
  if (c < 0x80)
    return c == ' ' || (c >= 0x09 && c <= 0x0D) ||
           (c >= 0x1C && c <= 0x1F);
  return in_ranges(c, kSpaceRanges, kSpaceRanges_len);
}

// \w equivalent (letters | digits | underscore)
bool is_word_char(u32 c) { return is_letter(c) || is_digit(c) || c == '_'; }

u32 ascii_lower(u32 c) { return (c >= 'A' && c <= 'Z') ? c + 32 : c; }

// ---------------------------------------------------------------------------
// filter_special_characters (LDAClustering.scala:283-284): replace the char
// class with a space.  Set matches textproc._SPECIAL_RE exactly:
//   » « ! @ # $ % ^ & * ( ) _ + - − , ” " ’ ' ; : . ` ?
// ---------------------------------------------------------------------------
bool is_special(u32 c) {
  switch (c) {
    case 0xBB: case 0xAB:                     // » «
    case '!': case '@': case '#': case '$': case '%': case '^': case '&':
    case '*': case '(': case ')': case '_': case '+': case '-':
    case 0x2212:                              // −
    case ',': case 0x201D: case '"': case 0x2019: case '\'': case ';':
    case ':': case '.': case '`': case '?':
      return true;
    default:
      return false;
  }
}

// ---------------------------------------------------------------------------
// Porter stemmer — NLTK PorterStemmer(mode="MARTIN_EXTENSIONS"),
// stem(word, to_lowercase=False): the published algorithm plus Martin's
// m>0 "bli"->"ble" / "logi"->"log" departures and the len<=2 early return,
// matching OpenNLP's tartarus port (see textproc.py for the frozen-vocab
// evidence).  Operates on code points; vowel tests use LOWERCASE ascii
// a/e/i/o/u only (so uppercase letters count as consonants, exactly like
// the Python original running on a non-lowercased string).
// ---------------------------------------------------------------------------
struct Porter {
  static bool is_vowel_char(u32 c) {
    return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u';
  }

  static bool is_consonant(const U32s& w, size_t i) {
    if (is_vowel_char(w[i])) return false;
    if (w[i] == 'y') {
      bool negate = false;
      while (i > 0 && w[i] == 'y') {
        negate = !negate;
        --i;
      }
      return (!is_vowel_char(w[i])) != negate;
    }
    return true;
  }

  static int measure(const U32s& stem) {
    int m = 0;
    bool prev_v = false;
    for (size_t i = 0; i < stem.size(); ++i) {
      bool v = !is_consonant(stem, i);
      if (prev_v && !v) ++m;
      prev_v = v;
    }
    return m;
  }

  static bool contains_vowel(const U32s& stem) {
    for (size_t i = 0; i < stem.size(); ++i)
      if (!is_consonant(stem, i)) return true;
    return false;
  }

  static bool ends_double_consonant(const U32s& w) {
    size_t n = w.size();
    return n >= 2 && w[n - 1] == w[n - 2] && is_consonant(w, n - 1);
  }

  static bool ends_cvc(const U32s& w) {
    size_t n = w.size();
    return n >= 3 && is_consonant(w, n - 3) && !is_consonant(w, n - 2) &&
           is_consonant(w, n - 1) && w[n - 1] != 'w' && w[n - 1] != 'x' &&
           w[n - 1] != 'y';
  }

  static bool ends_with(const U32s& w, const char* suf) {
    size_t m = strlen(suf);
    if (w.size() < m) return false;
    for (size_t i = 0; i < m; ++i)
      if (w[w.size() - m + i] != (u32)(unsigned char)suf[i]) return false;
    return true;
  }

  static U32s drop(const U32s& w, size_t m) {
    return U32s(w.begin(), w.end() - (long)m);
  }

  static void append(U32s& w, const char* s) {
    for (; *s; ++s) w.push_back((u32)(unsigned char)*s);
  }

  // one (suffix, replacement, condition) rule; returns true if the rule
  // MATCHED (whether or not the condition passed — matching stops the scan,
  // mirroring _apply_rule_list's early return on a failed condition)
  enum Cond { NONE, M_GT_0, M_GT_1, M_GT_1_ST };
  static bool try_rule(U32s& w, const char* suf, const char* rep, Cond cond) {
    if (!ends_with(w, suf)) return false;
    U32s stem = drop(w, strlen(suf));
    bool ok;
    switch (cond) {
      case NONE: ok = true; break;
      case M_GT_0: ok = measure(stem) > 0; break;
      case M_GT_1: ok = measure(stem) > 1; break;
      case M_GT_1_ST:
        ok = measure(stem) > 1 && !stem.empty() &&
             (stem.back() == 's' || stem.back() == 't');
        break;
    }
    if (ok) {
      append(stem, rep);
      w = std::move(stem);
    }
    return true;  // matched; stop scanning further rules
  }

  static U32s step1a(U32s w) {
    if (try_rule(w, "sses", "ss", NONE)) return w;
    if (try_rule(w, "ies", "i", NONE)) return w;
    if (try_rule(w, "ss", "ss", NONE)) return w;
    if (try_rule(w, "s", "", NONE)) return w;
    return w;
  }

  static U32s step1b(U32s w) {
    if (ends_with(w, "eed")) {
      U32s stem = drop(w, 3);
      if (measure(stem) > 0) {
        append(stem, "ee");
        return stem;
      }
      return w;
    }
    U32s inter;
    bool matched = false;
    if (ends_with(w, "ed")) {
      U32s s = drop(w, 2);
      if (contains_vowel(s)) {
        inter = std::move(s);
        matched = true;
      }
    }
    if (!matched && ends_with(w, "ing")) {
      U32s s = drop(w, 3);
      if (contains_vowel(s)) {
        inter = std::move(s);
        matched = true;
      }
    }
    if (!matched) return w;

    if (try_rule(inter, "at", "ate", NONE)) return inter;
    if (try_rule(inter, "bl", "ble", NONE)) return inter;
    if (try_rule(inter, "iz", "ize", NONE)) return inter;
    if (ends_double_consonant(inter)) {
      u32 last = inter.back();
      if (last != 'l' && last != 's' && last != 'z') inter.pop_back();
      return inter;  // rule matched either way — stop
    }
    if (measure(inter) == 1 && ends_cvc(inter)) {
      inter.push_back('e');
    }
    return inter;
  }

  static U32s step1c(U32s w) {
    // original condition: (*v*) Y -> I
    if (ends_with(w, "y")) {
      U32s stem = drop(w, 1);
      if (contains_vowel(stem)) {
        stem.push_back('i');
        return stem;
      }
    }
    return w;
  }

  static U32s step2(U32s w) {
    // MARTIN_EXTENSIONS rule list: bli variant (not abli), logi appended
    // last; no NLTK-only alli-first/fulli
    if (try_rule(w, "ational", "ate", M_GT_0)) return w;
    if (try_rule(w, "tional", "tion", M_GT_0)) return w;
    if (try_rule(w, "enci", "ence", M_GT_0)) return w;
    if (try_rule(w, "anci", "ance", M_GT_0)) return w;
    if (try_rule(w, "izer", "ize", M_GT_0)) return w;
    if (try_rule(w, "bli", "ble", M_GT_0)) return w;
    if (try_rule(w, "alli", "al", M_GT_0)) return w;
    if (try_rule(w, "entli", "ent", M_GT_0)) return w;
    if (try_rule(w, "eli", "e", M_GT_0)) return w;
    if (try_rule(w, "ousli", "ous", M_GT_0)) return w;
    if (try_rule(w, "ization", "ize", M_GT_0)) return w;
    if (try_rule(w, "ation", "ate", M_GT_0)) return w;
    if (try_rule(w, "ator", "ate", M_GT_0)) return w;
    if (try_rule(w, "alism", "al", M_GT_0)) return w;
    if (try_rule(w, "iveness", "ive", M_GT_0)) return w;
    if (try_rule(w, "fulness", "ful", M_GT_0)) return w;
    if (try_rule(w, "ousness", "ous", M_GT_0)) return w;
    if (try_rule(w, "aliti", "al", M_GT_0)) return w;
    if (try_rule(w, "iviti", "ive", M_GT_0)) return w;
    if (try_rule(w, "biliti", "ble", M_GT_0)) return w;
    if (try_rule(w, "logi", "log", M_GT_0)) return w;
    return w;
  }

  static U32s step3(U32s w) {
    if (try_rule(w, "icate", "ic", M_GT_0)) return w;
    if (try_rule(w, "ative", "", M_GT_0)) return w;
    if (try_rule(w, "alize", "al", M_GT_0)) return w;
    if (try_rule(w, "iciti", "ic", M_GT_0)) return w;
    if (try_rule(w, "ical", "ic", M_GT_0)) return w;
    if (try_rule(w, "ful", "", M_GT_0)) return w;
    if (try_rule(w, "ness", "", M_GT_0)) return w;
    return w;
  }

  static U32s step4(U32s w) {
    if (try_rule(w, "al", "", M_GT_1)) return w;
    if (try_rule(w, "ance", "", M_GT_1)) return w;
    if (try_rule(w, "ence", "", M_GT_1)) return w;
    if (try_rule(w, "er", "", M_GT_1)) return w;
    if (try_rule(w, "ic", "", M_GT_1)) return w;
    if (try_rule(w, "able", "", M_GT_1)) return w;
    if (try_rule(w, "ible", "", M_GT_1)) return w;
    if (try_rule(w, "ant", "", M_GT_1)) return w;
    if (try_rule(w, "ement", "", M_GT_1)) return w;
    if (try_rule(w, "ment", "", M_GT_1)) return w;
    if (try_rule(w, "ent", "", M_GT_1)) return w;
    if (try_rule(w, "ion", "", M_GT_1_ST)) return w;
    if (try_rule(w, "ou", "", M_GT_1)) return w;
    if (try_rule(w, "ism", "", M_GT_1)) return w;
    if (try_rule(w, "ate", "", M_GT_1)) return w;
    if (try_rule(w, "iti", "", M_GT_1)) return w;
    if (try_rule(w, "ous", "", M_GT_1)) return w;
    if (try_rule(w, "ive", "", M_GT_1)) return w;
    if (try_rule(w, "ize", "", M_GT_1)) return w;
    return w;
  }

  static U32s step5a(U32s w) {
    if (!w.empty() && w.back() == 'e') {
      U32s stem = drop(w, 1);
      int m = measure(stem);
      if (m > 1) return stem;
      if (m == 1 && !ends_cvc(stem)) return stem;
    }
    return w;
  }

  static U32s step5b(U32s w) {
    if (ends_with(w, "ll") && measure(drop(w, 1)) > 1) {
      w.pop_back();
    }
    return w;
  }

  static U32s stem(U32s w) {
    // martin-mode early return: strings of length <= 2 skip stemming
    if (w.size() <= 2) return w;
    w = step1a(std::move(w));
    w = step1b(std::move(w));
    w = step1c(std::move(w));
    w = step2(std::move(w));
    w = step3(std::move(w));
    w = step4(std::move(w));
    w = step5a(std::move(w));
    w = step5b(std::move(w));
    return w;
  }
};

// ---------------------------------------------------------------------------
// Rule lemmatizer — port of textproc.lemma() (CoreNLP morphology.lemma
// approximation).  Irregular table and suffix rules are byte-identical.
// ---------------------------------------------------------------------------
struct IrregularEntry {
  const char* from;
  const char* to;
};
const IrregularEntry kIrregular[] = {
    {"was", "be"},       {"were", "be"},     {"been", "be"},
    {"is", "be"},        {"are", "be"},      {"am", "be"},
    {"being", "be"},     {"has", "have"},    {"had", "have"},
    {"having", "have"},
    {"did", "do"},       {"does", "do"},     {"done", "do"},
    {"doing", "do"},
    {"went", "go"},      {"gone", "go"},     {"goes", "go"},
    {"going", "go"},
    {"said", "say"},     {"says", "say"},    {"saying", "say"},
    {"saw", "see"},      {"seen", "see"},
    {"made", "make"},    {"came", "come"},   {"taken", "take"},
    {"took", "take"},    {"given", "give"},  {"gave", "give"},
    {"got", "get"},      {"gotten", "get"},
    {"knew", "know"},    {"known", "know"},  {"thought", "think"},
    {"told", "tell"},    {"found", "find"},  {"left", "leave"},
    {"felt", "feel"},    {"kept", "keep"},   {"held", "hold"},
    {"brought", "bring"},{"stood", "stand"}, {"sat", "sit"},
    {"spoke", "speak"},  {"spoken", "speak"},{"heard", "hear"},
    {"meant", "mean"},
    // strong / irregular verbs
    {"abode", "abide"},  {"arose", "arise"}, {"arisen", "arise"},
    {"awoke", "awake"},  {"awoken", "awake"},{"bade", "bid"},
    {"begotten", "beget"},{"besought", "beseech"},{"hewn", "hew"},
    {"befallen", "befall"},{"befell", "befall"},{"beheld", "behold"},
    {"foresaw", "foresee"},{"foreseen", "foresee"},
    {"forsaken", "forsake"},{"forsook", "forsake"},{"leapt", "leap"},
    {"outgrown", "outgrow"},{"overheard", "overhear"},
    {"overtaken", "overtake"},{"overthrown", "overthrow"},
    {"overtook", "overtake"},{"undergone", "undergo"},
    {"undertaken", "undertake"},{"undertook", "undertake"},
    {"withdrawn", "withdraw"},{"withheld", "withhold"},
    {"slain", "slay"},   {"slew", "slay"},   {"slung", "sling"},
    {"smitten", "smite"},{"smote", "smite"}, {"spat", "spit"},
    {"stank", "stink"},  {"striven", "strive"},{"strode", "stride"},
    {"swollen", "swell"},{"trodden", "tread"},
    {"ate", "eat"},      {"eaten", "eat"},   {"became", "become"},
    {"began", "begin"},  {"begun", "begin"}, {"bent", "bend"},
    {"bitten", "bite"},  {"blew", "blow"},   {"blown", "blow"},
    {"bore", "bear"},    {"borne", "bear"},  {"bought", "buy"},
    {"bred", "breed"},   {"broke", "break"}, {"broken", "break"},
    {"built", "build"},  {"burnt", "burn"},  {"caught", "catch"},
    {"chose", "choose"}, {"chosen", "choose"},{"clung", "cling"},
    {"crept", "creep"},  {"dealt", "deal"},  {"drank", "drink"},
    {"drunk", "drink"},  {"dreamt", "dream"},{"drew", "draw"},
    {"drawn", "draw"},   {"drove", "drive"}, {"driven", "drive"},
    {"dug", "dig"},      {"fed", "feed"},    {"fell", "fall"},
    {"fallen", "fall"},  {"fled", "flee"},   {"flew", "fly"},
    {"flown", "fly"},    {"flung", "fling"}, {"forbade", "forbid"},
    {"forgave", "forgive"},{"forgot", "forget"},{"forgotten", "forget"},
    {"fought", "fight"}, {"froze", "freeze"},{"frozen", "freeze"},
    {"grew", "grow"},    {"grown", "grow"},  {"hid", "hide"},
    {"hidden", "hide"},  {"hung", "hang"},   {"knelt", "kneel"},
    {"laid", "lay"},     {"lain", "lie"},    {"leant", "lean"},
    {"learnt", "learn"}, {"led", "lead"},    {"lent", "lend"},
    {"lit", "light"},    {"lost", "lose"},   {"met", "meet"},
    {"mistook", "mistake"},{"overcame", "overcome"},{"paid", "pay"},
    {"ran", "run"},      {"rang", "ring"},   {"rung", "ring"},
    {"rode", "ride"},    {"ridden", "ride"}, {"risen", "rise"},
    {"sang", "sing"},    {"sung", "sing"},   {"sank", "sink"},
    {"sunk", "sink"},    {"sent", "send"},   {"shook", "shake"},
    {"shaken", "shake"}, {"shone", "shine"}, {"shot", "shoot"},
    {"shown", "show"},   {"shrank", "shrink"},{"slept", "sleep"},
    {"slid", "slide"},   {"sold", "sell"},   {"sought", "seek"},
    {"sped", "speed"},   {"spent", "spend"}, {"spun", "spin"},
    {"sprang", "spring"},{"sprung", "spring"},{"stole", "steal"},
    {"stolen", "steal"}, {"stuck", "stick"}, {"stung", "sting"},
    {"strove", "strive"},{"struck", "strike"},{"swam", "swim"},
    {"swum", "swim"},    {"swept", "sweep"}, {"swore", "swear"},
    {"sworn", "swear"},  {"swung", "swing"}, {"taught", "teach"},
    {"threw", "throw"},  {"thrown", "throw"},{"tore", "tear"},
    {"torn", "tear"},    {"trod", "tread"},  {"understood", "understand"},
    {"wept", "weep"},    {"woke", "wake"},   {"woken", "wake"},
    {"won", "win"},      {"wore", "wear"},   {"worn", "wear"},
    {"wove", "weave"},   {"woven", "weave"}, {"withdrew", "withdraw"},
    {"wrote", "write"},  {"written", "write"},{"wrung", "wring"},
    // irregular plurals
    {"men", "man"},      {"women", "woman"}, {"children", "child"},
    {"feet", "foot"},    {"teeth", "tooth"}, {"mice", "mouse"},
    {"people", "person"},{"wives", "wife"},  {"lives", "life"},
    {"leaves", "leaf"},  {"selves", "self"}, {"eyes", "eye"},
    {"gentlemen", "gentleman"},{"countrymen", "countryman"},
    {"fishermen", "fisherman"},{"workmen", "workman"},
    {"horsemen", "horseman"},{"policemen", "policeman"},
    {"seamen", "seaman"},{"townsmen", "townsman"},
    {"kinsmen", "kinsman"},{"madmen", "madman"},
    {"frenchmen", "frenchman"},{"englishmen", "englishman"},
    {"clergymen", "clergyman"},{"noblemen", "nobleman"},
    {"footmen", "footman"},{"huntsmen", "huntsman"},
    {"boatmen", "boatman"},{"statesmen", "statesman"},
    {"tradesmen", "tradesman"},{"watchmen", "watchman"},
    {"foremen", "foreman"},{"firemen", "fireman"},
    {"midshipmen", "midshipman"},{"oarsmen", "oarsman"},
    {"herdsmen", "herdsman"},{"marksmen", "marksman"},
    {"wolves", "wolf"},{"knives", "knife"},
    {"thieves", "thief"},{"shelves", "shelf"},{"halves", "half"},
    {"calves", "calf"},  {"elves", "elf"},   {"loaves", "loaf"},
    {"geese", "goose"},  {"oxen", "ox"},
    // suppletive comparatives
    {"better", "good"},  {"best", "good"},   {"worse", "bad"},
    {"worst", "bad"},
};

const char* irregular_lookup(const string& low) {
  static const std::unordered_map<string, const char*> kMap = [] {
    std::unordered_map<string, const char*> m;
    for (auto& e : kIrregular) m.emplace(e.from, e.to);
    return m;
  }();
  auto it = kMap.find(low);
  return it == kMap.end() ? nullptr : it->second;
}

// Python's _strip_double compares RAW chars (`stem_[-1] not in "ls"` — an
// uppercase 'L'/'S' would not match), so this mirrors the raw comparison.
U32s strip_double_raw(const U32s& stem) {
  size_t n = stem.size();
  if (n >= 2 && stem[n - 1] == stem[n - 2] &&
      !(stem[n - 1] == 'a' || stem[n - 1] == 'e' || stem[n - 1] == 'i' ||
        stem[n - 1] == 'o' || stem[n - 1] == 'u') &&
      stem[n - 1] != 'l' && stem[n - 1] != 's' && stem[n - 1] != 'f' &&
      stem[n - 1] != 'z') {  // fall, miss, sniff, buzz keep doubles
    return U32s(stem.begin(), stem.end() - 1);
  }
  return stem;
}

bool lower_is_vowel(u32 c) {
  u32 l = ascii_lower(c);
  return l == 'a' || l == 'e' || l == 'i' || l == 'o' || l == 'u';
}

// textproc._needs_e(stem_.lower()): called on the LOWERCASED stem.
// Mirrors the Python rule set exactly: [sz] not preceded by s/z, then CVC
// with the -er/-en/-on/-el/-om unstressed-syllable exclusions (see
// textproc.py for the Porter-equalization rationale).
bool needs_e_lower(const U32s& low) {
  size_t n = low.size();
  if (n >= 2 && (low[n - 1] == 's' || low[n - 1] == 'z') &&
      low[n - 2] != 's' && low[n - 2] != 'z')
    return true;
  // associate/appreciate-class "-iat" stems (V,V,C fails the CVC test)
  if (n >= 3 && low[n - 3] == 'i' && low[n - 2] == 'a' && low[n - 1] == 't')
    return true;
  if (n < 3) return false;
  u32 c1 = low[n - 3], v = low[n - 2], c2 = low[n - 1];
  bool cond = !lower_is_vowel(c2) && c2 != 'w' && c2 != 'x' && c2 != 'y' &&
              lower_is_vowel(v) && !lower_is_vowel(c1);
  if (!cond) return false;
  // _NO_E_SUFFIXES = ("er", "en", "on", "el", "om")
  u32 a = low[n - 2], b = low[n - 1];
  if ((a == 'e' && (b == 'r' || b == 'n' || b == 'l')) ||
      (a == 'o' && (b == 'n' || b == 'm')))
    return false;
  return true;
}

bool any_vowel_lower(const U32s& w) {
  for (u32 c : w)
    if (lower_is_vowel(c)) return true;
  return false;
}

U32s ascii_lower_all(const U32s& w) {
  U32s out = w;
  for (auto& c : out) c = ascii_lower(c);
  return out;
}

bool ends_with_low(const U32s& low, const char* suf) {
  return Porter::ends_with(low, suf);
}

U32s lemma(const U32s& word) {
  U32s low = ascii_lower_all(word);
  // irregular table: keys are pure-ASCII, so an ASCII-lower lookup matches
  // Python's full .lower() for every word that can possibly hit the table
  // (longest key: "understood", 10)
  if (low.size() <= 10) {
    bool all_ascii = true;
    for (u32 c : low)
      if (c >= 0x80) {
        all_ascii = false;
        break;
      }
    if (all_ascii) {
      string lows;
      for (u32 c : low) lows += (char)c;
      if (const char* to = irregular_lookup(lows)) {
        U32s out;
        for (const char* p = to; *p; ++p) out.push_back((u32)(unsigned char)*p);
        // word[0] + out[1:] if word[0].isupper() and len(out) > 1
        if (word[0] >= 'A' && word[0] <= 'Z' && out.size() > 1) {
          U32s cased;
          cased.push_back(word[0]);
          cased.insert(cased.end(), out.begin() + 1, out.end());
          return cased;
        }
        return out;
      }
    }
  }

  size_t n = low.size();
  // plural / 3rd-person -s
  if (ends_with_low(low, "ies") && n > 4) {
    U32s out(word.begin(), word.end() - 3);
    out.push_back('y');
    return out;
  }
  if (ends_with_low(low, "sses") || ends_with_low(low, "shes") ||
      ends_with_low(low, "ches") || ends_with_low(low, "xes") ||
      ends_with_low(low, "zes")) {
    return U32s(word.begin(), word.end() - 2);
  }
  if (ends_with_low(low, "s") && !ends_with_low(low, "ss") &&
      !ends_with_low(low, "us") && !ends_with_low(low, "is") && n > 3) {
    return U32s(word.begin(), word.end() - 1);
  }
  // -ing
  if (ends_with_low(low, "ing") && n > 5) {
    U32s stem(word.begin(), word.end() - 3);
    if (!any_vowel_lower(stem)) return word;
    U32s stripped = strip_double_raw(stem);
    if (stripped != stem) return stripped;
    if (needs_e_lower(ascii_lower_all(stem))) {
      U32s out = stem;
      out.push_back('e');
      return out;
    }
    return stem;
  }
  // -ed
  if (ends_with_low(low, "ied") && n > 4) {
    U32s out(word.begin(), word.end() - 3);
    out.push_back('y');
    return out;
  }
  if (ends_with_low(low, "eed")) {
    // leave -eed words whole: Porter step-1b handles both classes
    return word;
  }
  if (ends_with_low(low, "ed") && n > 4) {
    U32s stem(word.begin(), word.end() - 2);
    if (!any_vowel_lower(stem)) return word;
    U32s stripped = strip_double_raw(stem);
    if (stripped != stem) return stripped;
    if (needs_e_lower(ascii_lower_all(stem))) {
      U32s out = stem;
      out.push_back('e');
      return out;
    }
    return stem;
  }
  return word;
}

// ---------------------------------------------------------------------------
// textproc._simple_lower: 1:1 per-code-point lowercase via kLowerPairs
// (binary search; multi-char lowerings are identity on both sides).
// ---------------------------------------------------------------------------
u32 simple_lower_cp(u32 c) {
  size_t lo = 0, hi = kLowerPairs_len;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (kLowerPairs[mid][0] < c)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo < kLowerPairs_len && kLowerPairs[lo][0] == c)
    return kLowerPairs[lo][1];
  return c;
}

U32s simple_lower(const U32s& w) {
  U32s out = w;
  for (auto& c : out) c = simple_lower_cp(c);
  return out;
}

// ---------------------------------------------------------------------------
// textproc._split_contraction: (base, clitic lemma or nullptr).  Unknown
// apostrophe forms keep the whole word as base (old single-word path).
// ---------------------------------------------------------------------------
struct SplitWord {
  U32s base;
  const char* clitic;  // nullptr = no clitic token
};

SplitWord split_contraction(const U32s& w) {
  size_t i = 0, n = w.size();
  for (; i < n; ++i)
    if (w[i] == '\'' || w[i] == 0x2019) break;
  if (i == n) return {w, nullptr};
  U32s base(w.begin(), w.begin() + (long)i);
  string suf;  // ascii-lowered suffix; non-ascii cannot hit the map
  bool ascii = true;
  for (size_t j = i + 1; j < n; ++j) {
    if (w[j] >= 0x80) {
      ascii = false;
      break;
    }
    suf += (char)ascii_lower(w[j]);
  }
  if (ascii) {
    if (suf == "t" && base.size() > 1 &&
        simple_lower_cp(base.back()) == (u32)'n') {
      base.pop_back();  // isn't -> is + not
      return {std::move(base), "not"};
    }
    if (suf == "ll") return {std::move(base), "will"};
    if (suf == "ve") return {std::move(base), "have"};
    if (suf == "re") return {std::move(base), "be"};
    if (suf == "d") return {std::move(base), "would"};
    if (suf == "s" || suf == "m") return {std::move(base), nullptr};
  }
  return {w, nullptr};
}

// ---------------------------------------------------------------------------
// lemmatize_text (textproc.lemmatize_text): sentence split on
// (?<=[.!?])\s+, word regex [^\W\d_]+(?:['’][^\W\d_]+)?, optional
// within-sentence dedup on the RAW word, contraction split, document-level
// case folding (fold a non-lowercase base when its lowercase form occurs
// anywhere in the document), lemma, keep len > min_len, clitic lemma after
// its base.
// ---------------------------------------------------------------------------
// PTB-shaped word units (textproc._WORD_RE):
//   (?:[^\W\d_]|\d)+(?:[-'’.,](?:[^\W\d_]|\d)+)*
// alphanumeric runs joined by single internal hyphens / apostrophes /
// periods / commas — "to-day", "310,000" and "1756" stay ONE unit
// through the lemma + length filter, splitting only at the tokenize
// step (this is how the frozen vocabularies hold pure numbers and
// sub-4-char fragments).
bool is_unit_char(u32 c) {
  return (is_letter(c) || is_digit(c)) && c != '_';
}

bool is_unit_joiner(u32 c) {
  return c == '-' || c == '\'' || c == 0x2019 || c == '.' || c == ',';
}

void words_of_sentence(const U32s& sent, vector<U32s>& out) {
  size_t i = 0, n = sent.size();
  while (i < n) {
    if (!is_unit_char(sent[i])) {
      ++i;
      continue;
    }
    size_t j = i;
    while (j < n && is_unit_char(sent[j])) ++j;
    while (j < n && is_unit_joiner(sent[j]) && j + 1 < n &&
           is_unit_char(sent[j + 1])) {
      ++j;
      while (j < n && is_unit_char(sent[j])) ++j;
    }
    out.emplace_back(sent.begin() + (long)i, sent.begin() + (long)j);
    i = j;
  }
}

// ---------------------------------------------------------------------------
// foreign-mode tagger emulation (textproc._foreign_fold): deterministic
// per-occurrence fold of capitalized no-twin words in documents whose
// no-twin capitalized TYPE ratio crosses the gate.  Rates come from the
// generated per-suffix table; verdicts hash (word, sentence index).
// ---------------------------------------------------------------------------
constexpr double kForeignCapsGate = 0.25;

uint64_t fnv1a64(const string& data, uint64_t h = 0xCBF29CE484222325ULL) {
  for (unsigned char b : data) {
    h ^= (uint64_t)b;
    h *= 0x100000001B3ULL;
  }
  return h;
}

int suffix_fold_rate(const U32s& low) {
  for (int ln = 4; ln >= 2; --ln) {
    if ((int)low.size() > ln) {
      U32s suf(low.end() - ln, low.end());
      auto it = kNnpSuffixRates.find(encode_utf8(suf));
      if (it != kNnpSuffixRates.end()) return it->second;
    }
  }
  return 0;
}

bool foreign_fold(const U32s& base, const U32s& low, size_t sent_idx,
                  int n_occ) {
  int rate = suffix_fold_rate(low);
  if (rate <= 0) return false;
  if (rate >= 1000) return true;
  if (n_occ <= 1) return rate >= 500;  // single sample: majority verdict
  uint64_t h = fnv1a64(encode_utf8(base));
  string idx(4, '\0');
  for (int b = 0; b < 4; ++b)
    idx[(size_t)b] = (char)((sent_idx >> (8 * b)) & 0xFF);
  h = fnv1a64(idx, h);
  return (int)(h % 1000) < rate;
}

U32s lemmatize_text(const U32s& text, int min_len_exclusive, bool dedup,
                    bool fold_case) {
  U32s out;
  size_t n = text.size();
  size_t start = 0;
  vector<std::pair<size_t, size_t>> sentences;
  // split on (?<=[.!?])\s+  — boundary AFTER .!? at a whitespace run
  for (size_t i = 0; i + 1 < n; ++i) {
    u32 c = text[i];
    if ((c == '.' || c == '!' || c == '?') && is_space(text[i + 1])) {
      size_t j = i + 1;
      while (j < n && is_space(text[j])) ++j;
      sentences.emplace_back(start, i + 1);
      start = j;
      i = j - 1;
    }
  }
  sentences.emplace_back(start, n);

  // pass 1: dedup raw words, split contractions, collect lowercase bases
  // and NNP evidence (capitalized forms seen past a sentence start; the
  // evidence scan runs BEFORE dedup, like the Python twin)
  vector<vector<SplitWord>> sent_parts;
  sent_parts.reserve(sentences.size());
  std::unordered_set<string> lower_bases;
  std::unordered_set<string> noninitial_caps;
  std::unordered_set<string> all_bases;
  std::unordered_map<string, int> caps_occ;
  std::unordered_set<string> seen;
  vector<U32s> words;
  for (auto& [s, e] : sentences) {
    U32s sent(text.begin() + (long)s, text.begin() + (long)e);
    words.clear();
    words_of_sentence(sent, words);
    if (fold_case) {
      for (size_t wi = 0; wi < words.size(); ++wi) {
        U32s base = split_contraction(words[wi]).base;
        string key = encode_utf8(base);
        all_bases.insert(key);
        if (base == simple_lower(base)) {
          lower_bases.insert(std::move(key));
        } else {
          ++caps_occ[key];
          if (wi > 0) noninitial_caps.insert(std::move(key));
        }
      }
    }
    seen.clear();
    sent_parts.emplace_back();
    auto& parts = sent_parts.back();
    for (auto& w : words) {
      if (dedup) {
        string key = encode_utf8(w);
        if (!seen.insert(std::move(key)).second) continue;
      }
      parts.push_back(split_contraction(w));
    }
  }

  // foreign-mode gate: distinct capitalized no-twin types / distinct
  // types, computed after pass 1 (the no-twin test needs the complete
  // lower_bases set) — mirrors textproc.lemmatize_text
  bool foreign = false;
  if (fold_case && !all_bases.empty()) {
    size_t no_twin = 0;
    for (const auto& c : noninitial_caps) {
      U32s low = simple_lower(decode_utf8(c.data(), c.size()));
      if (!lower_bases.count(encode_utf8(low))) ++no_twin;
    }
    foreign =
        (double)no_twin / (double)all_bases.size() >= kForeignCapsGate;
  }

  // pass 2: fold, lemma, emit (clitic lemma follows its base)
  for (size_t si = 0; si < sent_parts.size(); ++si) {
    auto& parts = sent_parts[si];
    for (auto& p : parts) {
      U32s base = p.base;
      bool is_nnp = false;
      if (fold_case) {
        U32s low = simple_lower(base);
        if (low != base) {
          string key = encode_utf8(base);
          auto occ = caps_occ.find(key);
          if (lower_bases.count(encode_utf8(low)))
            base = std::move(low);
          else if (foreign &&
                   foreign_fold(base, low, si,
                                occ == caps_occ.end() ? 0 : occ->second))
            // per-occurrence tagger emulation (see foreign_fold)
            base = std::move(low);
          else if (noninitial_caps.count(key))
            // NNP-ish: capitalized, no lowercase twin in the document,
            // and seen mid-sentence at least once — CoreNLP returns NNP
            // lemmas unchanged (no plural strip).  Sentence-initial-only
            // capitalized forms still lemmatize normally.
            is_nnp = true;
        }
      }
      U32s lm = is_nnp ? base : lemma(base);
      if ((int)lm.size() > min_len_exclusive) {
        if (!out.empty()) out.push_back(' ');
        out.insert(out.end(), lm.begin(), lm.end());
      }
      if (p.clitic) {
        size_t cl = strlen(p.clitic);
        if ((int)cl > min_len_exclusive) {
          if (!out.empty()) out.push_back(' ');
          for (const char* q = p.clitic; *q; ++q)
            out.push_back((u32)(unsigned char)*q);
        }
      }
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// simple_tokenize (textproc._TOKEN_RE): [^\W\d_]+ | \d+ | [^\w\s]+
// ---------------------------------------------------------------------------
void simple_tokenize(const U32s& text, vector<U32s>& out) {
  size_t i = 0, n = text.size();
  while (i < n) {
    u32 c = text[i];
    if (is_letter(c)) {  // [^\W\d_]+ : letters (not digit, not underscore)
      size_t j = i;
      while (j < n && is_letter(text[j])) ++j;
      out.emplace_back(text.begin() + (long)i, text.begin() + (long)j);
      i = j;
    } else if (is_digit(c)) {  // \d+
      size_t j = i;
      while (j < n && is_digit(text[j])) ++j;
      out.emplace_back(text.begin() + (long)i, text.begin() + (long)j);
      i = j;
    } else if (!is_space(c) && !is_word_char(c)) {  // [^\w\s]+
      size_t j = i;
      while (j < n && !is_space(text[j]) && !is_word_char(text[j])) ++j;
      out.emplace_back(text.begin() + (long)i, text.begin() + (long)j);
      i = j;
    } else {
      ++i;  // whitespace or underscore (matches nothing in the regex)
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------
extern "C" {

// Full preprocess_document pipeline.  ``text_len`` is the byte length of
// ``text`` — passed explicitly so documents containing embedded NUL bytes
// (stray binary files ingested with include_all) are processed in full,
// exactly like the Python path.  stop_words_nl: '\n'-joined UTF-8 stop
// words (case-sensitive, applied pre-stemming).  Returns a malloc'd
// '\n'-joined UTF-8 token buffer (empty string when no tokens); caller must
// free with stc_free.  Thread-safe, no global state.
char* stc_preprocess(const char* text, long text_len,
                     const char* stop_words_nl,
                     int lemmatize, int min_lemma_len_exclusive, int dedup,
                     int fold_case, long* out_len) {
  std::unordered_set<string> stops;
  if (stop_words_nl && *stop_words_nl) {
    const char* p = stop_words_nl;
    while (*p) {
      const char* q = strchr(p, '\n');
      size_t len = q ? (size_t)(q - p) : strlen(p);
      if (len) stops.emplace(p, len);
      if (!q) break;
      p = q + 1;
    }
  }

  U32s cps = decode_utf8(text, (size_t)text_len);
  if (lemmatize) {
    cps = lemmatize_text(cps, min_lemma_len_exclusive, dedup != 0,
                         fold_case != 0);
  }
  // filter_special_characters
  for (auto& c : cps)
    if (is_special(c)) c = ' ';

  vector<U32s> toks;
  simple_tokenize(cps, toks);

  string out;
  out.reserve(toks.size() * 8);
  for (auto& t : toks) {
    if (t.empty()) continue;
    string raw = encode_utf8(t);
    if (stops.count(raw)) continue;
    U32s stemmed = Porter::stem(std::move(t));
    if (stemmed.empty()) continue;
    if (!out.empty()) out += '\n';
    out += encode_utf8(stemmed);
  }

  // length returned out-of-band: punct-run tokens can contain NUL bytes
  // (e.g. from binary junk files), which would truncate a strlen read
  if (out_len) *out_len = (long)out.size();
  char* buf = (char*)malloc(out.size() + 1);
  memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  return buf;
}

// Porter stem of one token (parity probe for tests).
char* stc_stem(const char* token) {
  U32s cps = decode_utf8(token, strlen(token));
  string out = encode_utf8(Porter::stem(std::move(cps)));
  char* buf = (char*)malloc(out.size() + 1);
  memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  return buf;
}

// Rule lemma of one word (parity probe for tests).
char* stc_lemma(const char* word) {
  U32s cps = decode_utf8(word, strlen(word));
  string out = cps.empty() ? string() : encode_utf8(lemma(cps));
  char* buf = (char*)malloc(out.size() + 1);
  memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  return buf;
}

void stc_free(char* p) { free(p); }

int stc_abi_version() { return 3; }

}  // extern "C"
