/* The port's SMF core: one call a song.
 *
 * apps/hjm_mixer.note_groups' Python path reads a Standard MIDI File a
 * byte at a time through models/midi.MidiFile (a dict and a bisect an
 * event), pairs its notes in collect_notes and groups them round-robin in
 * a Python loop: some 8 ms for a song of 1,500 notes.  note_groups() here
 * does all of it in one pass over the bytes and returns what the Python
 * path returns: the notes as (onset, end, note) tuples in collect_notes'
 * order, and the groups as a dict from (instrument, note) to a list of
 * onsets, keys in first-seen order, onsets in note order.
 *
 * Bit for bit with the Python path: built with -ffp-contract=off, every
 * double operation rounds on its own, in CPython's order (the tempo map's
 * secs[i] + (tick - ticks[i]) * uspq[i] / 1e6 / division, the integer
 * product exact in int64 and rounded once on its way to a double, as
 * CPython's int / float rounds it).  The pending notes keep the insertion
 * order of collect_notes' dict (a pop and a re-insert moves a key to the
 * end); the sort by onset is stable.
 *
 * The core declines (returns None) any song it does not mirror exactly,
 * and the caller runs the Python path, which gives its result or raises
 * its exception: data that is not bytes, a header that is not MThd or
 * shorter than 6 bytes, an SMPTE or zero division, a chunk other than
 * MTrk where a track is expected, a read past the end of a chunk or of
 * the file (the Python reader's take() returns short bytes there, its
 * u8() raises), a tick over 2**32, and arguments that are not ints in
 * range (or a note length that is not a float).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define TICK_MAX (1LL << 32)    /* keeps tick x uspq (uspq < 2**24) exact */
#define NOTES 256               /* a note number is one byte of the file */
#define KEYS (16 * NOTES)       /* collect_notes' (channel, note) keys */
#define BANKS_MAX 64
#define DEFAULT_USPQ 500000

typedef struct {
    int64_t tick, uspq;
} Tempo;

typedef struct {
    int64_t tick;
    int key;                    /* channel * NOTES + note */
    int on;
} Event;

typedef struct {
    Tempo *tempos;
    Py_ssize_t nt;
    Event *events;
    Py_ssize_t ne;
} Song;

/* _Reader.varint within [*q, e): 0 where it would read past e or its
 * value outgrows 2**57 */
static int varint(const uint8_t *d, Py_ssize_t *q, Py_ssize_t e,
                  int64_t *out) {
    uint64_t v = 0;
    for (;;) {
        if (*q >= e || v >= (1ULL << 50)) return 0;
        uint8_t b = d[(*q)++];
        v = (v << 7) | (b & 0x7F);
        if (!(b & 0x80)) {
            *out = (int64_t)v;
            return 1;
        }
    }
}

/* MidiFile._parse_track over the chunk [q, e): its tempos and its note
 * events appended to the song's; 0 to decline */
static int parse_track(const uint8_t *d, Py_ssize_t q, Py_ssize_t e,
                       Song *s) {
    int64_t tick = 0, v;
    int status = 0;
    while (q < e) {
        if (!varint(d, &q, e, &v)) return 0;
        tick += v;
        if (tick > TICK_MAX || q >= e) return 0;
        int b = d[q++];
        if (b == 0xFF) {                        /* meta */
            if (q >= e) return 0;
            int mtype = d[q++];
            int64_t mlen;
            if (!varint(d, &q, e, &mlen) || mlen > e - q) return 0;
            if (mtype == 0x51 && mlen == 3) {
                s->tempos[s->nt].tick = tick;
                s->tempos[s->nt].uspq = ((int64_t)d[q] << 16)
                    | ((int64_t)d[q + 1] << 8) | d[q + 2];
                s->nt++;
            }
            q += mlen;
            if (mtype == 0x2F) break;
            continue;
        }
        if (b == 0xF0 || b == 0xF7) {           /* sysex */
            int64_t slen;
            if (!varint(d, &q, e, &slen) || slen > e - q) return 0;
            q += slen;
            continue;
        }
        int d0, d1 = 0;
        if (b & 0x80) {
            status = b;
            if (q >= e) return 0;
            d0 = d[q++];
        } else {                                /* running status */
            d0 = b;
        }
        int kind = status & 0xF0;
        if (kind == 0x80 || kind == 0x90 || kind == 0xA0 || kind == 0xB0
                || kind == 0xE0) {
            if (q >= e) return 0;
            d1 = d[q++];
        }
        if (kind == 0x80 || kind == 0x90) {
            Event *ev = &s->events[s->ne++];
            ev->tick = tick;
            ev->key = (status & 0x0F) * NOTES + d0;
            ev->on = kind == 0x90 && d1 > 0;
        }
    }
    return 1;
}

/* The MidiFile constructor's reads: header, then up to its count of MTrk
 * chunks; 0 to decline, *division set */
static int parse_file(const uint8_t *d, Py_ssize_t n, Song *s,
                      int64_t *division) {
    if (n < 14 || memcmp(d, "MThd", 4) != 0) return 0;
    int64_t hlen = ((int64_t)d[4] << 24) | (d[5] << 16) | (d[6] << 8) | d[7];
    if (hlen < 6 || hlen > n - 8) return 0;
    int ntrks = (d[10] << 8) | d[11];
    int div = (d[12] << 8) | d[13];
    if (div & 0x8000 || div == 0) return 0;
    *division = div;
    Py_ssize_t p = 8 + hlen;
    for (int t = 0; t < ntrks; t++) {
        if (p >= n) break;
        if (n - p < 8 || memcmp(d + p, "MTrk", 4) != 0) return 0;
        int64_t tlen = ((int64_t)d[p + 4] << 24) | (d[p + 5] << 16)
            | (d[p + 6] << 8) | d[p + 7];
        p += 8;
        if (tlen > n - p) return 0;
        if (!parse_track(d, p, p + tlen, s)) return 0;
        p += tlen;
    }
    return 1;
}

static int tempo_cmp(const void *a, const void *b) {
    const Tempo *x = a, *y = b;
    if (x->tick != y->tick) return x->tick < y->tick ? -1 : 1;
    return (x->uspq > y->uspq) - (x->uspq < y->uspq);
}

/* result order: by onset, ties by position (Python's stable sort).  The
 * comparators read their keys from these statics, set just before each
 * qsort: no Python call comes between, so the GIL is held throughout and
 * no other thread's call can change them */
static const double *sort_onsets;

static int onset_cmp(const void *a, const void *b) {
    Py_ssize_t i = *(const Py_ssize_t *)a, j = *(const Py_ssize_t *)b;
    double u = sort_onsets[i], v = sort_onsets[j];
    if (u < v) return -1;
    if (v < u) return 1;
    return (i > j) - (i < j);
}

static const int64_t *sort_seqs;

static int seq_cmp(const void *a, const void *b) {
    int64_t u = sort_seqs[*(const int *)a], v = sort_seqs[*(const int *)b];
    return (u > v) - (u < v);
}

/* An int argument within +-lim: 1 and its value, 0 for anything else */
static int take_int(PyObject *o, long long lim, long long *out) {
    if (!PyLong_Check(o)) return 0;
    int overflow;
    long long v = PyLong_AsLongLongAndOverflow(o, &overflow);
    if (overflow || v > lim || v < -lim) return 0;
    *out = v;
    return 1;
}

static PyObject *note_groups(PyObject *self, PyObject *const *args,
                             Py_ssize_t nargs) {
    if (nargs != 7) {
        PyErr_SetString(PyExc_TypeError,
                        "note_groups takes (data, min_note, max_note, dnote, "
                        "offset, note_length, banks)");
        return NULL;
    }
    long long min_note, max_note, dnote, offset, nbanks;
    if (!PyBytes_CheckExact(args[0])
            || !take_int(args[1], LLONG_MAX, &min_note)
            || !take_int(args[2], LLONG_MAX, &max_note)
            || !take_int(args[3], 1LL << 60, &dnote)
            || !take_int(args[4], 1LL << 53, &offset)
            || !PyFloat_CheckExact(args[5])
            || !take_int(args[6], BANKS_MAX, &nbanks) || nbanks < 1)
        Py_RETURN_NONE;
    double note_length = PyFloat_AS_DOUBLE(args[5]);
    const uint8_t *d = (const uint8_t *)PyBytes_AS_STRING(args[0]);
    Py_ssize_t n = PyBytes_GET_SIZE(args[0]);

    PyObject *result = NULL, *notes = NULL, *groups = NULL;
    Song s = {0};
    double *secs = NULL, *onset = NULL, *end = NULL, *gsec = NULL;
    int *note = NULL, *gid = NULL, *left = NULL, *gcount = NULL;
    int *slot_gid = NULL, *gslot = NULL;
    PyObject **lists = NULL;
    int ng = 0;
    Py_ssize_t *order = NULL, *ofs = NULL;
    int64_t *seq = NULL;
    /* an event takes at least 2 bytes of the file, a tempo 7 */
    s.events = malloc(sizeof(Event) * (n / 2 + 1));
    s.tempos = malloc(sizeof(Tempo) * (n / 7 + 2));
    if (!s.events || !s.tempos) goto nomem;
    int64_t division;
    if (!parse_file(d, n, &s, &division)) goto decline;

    /* TempoMap: the tempos sorted as tuples, (0, 500000) first unless a
     * tempo sits at tick 0 */
    qsort(s.tempos, s.nt, sizeof(Tempo), tempo_cmp);
    if (s.nt == 0 || s.tempos[0].tick != 0) {
        memmove(s.tempos + 1, s.tempos, sizeof(Tempo) * s.nt);
        s.tempos[0].tick = 0;
        s.tempos[0].uspq = DEFAULT_USPQ;
        s.nt++;
    }
    Py_ssize_t nt = s.nt;
    const Tempo *tp = s.tempos;
    const double ddiv = (double)division;
    secs = malloc(sizeof(double) * nt);
    if (!secs) goto nomem;
    double acc = 0.0;
    for (Py_ssize_t i = 0; i < nt; i++) {
        secs[i] = acc;
        if (i + 1 < nt)
            acc += (double)((tp[i + 1].tick - tp[i].tick) * tp[i].uspq)
                / 1e6 / ddiv;
    }

    /* collect_notes: pairs by (channel, note) in file order */
    Py_ssize_t cap = s.ne + 1, nn = 0;
    onset = malloc(sizeof(double) * cap);
    end = malloc(sizeof(double) * cap);
    note = malloc(sizeof(int) * cap);
    seq = malloc(sizeof(int64_t) * KEYS);
    double pend[KEYS];
    if (!onset || !end || !note || !seq) goto nomem;
    for (int k = 0; k < KEYS; k++) seq[k] = -1;
    for (Py_ssize_t k = 0; k < s.ne; k++) {
        const Event *ev = &s.events[k];
        /* TempoMap.to_sec: bisect_right(ticks, tick) - 1 */
        Py_ssize_t lo = 0, hi = nt;
        while (lo < hi) {
            Py_ssize_t mid = (lo + hi) / 2;
            if (ev->tick < tp[mid].tick) hi = mid;
            else lo = mid + 1;
        }
        Py_ssize_t i = lo - 1;
        double sec = secs[i]
            + (double)((ev->tick - tp[i].tick) * tp[i].uspq) / 1e6 / ddiv;
        int key = ev->key;
        if (ev->on) {
            if (seq[key] >= 0) {
                onset[nn] = pend[key];
                end[nn] = pend[key] + note_length;
                note[nn++] = key % NOTES;
            }
            pend[key] = sec;
            seq[key] = k;
        } else if (seq[key] >= 0) {
            onset[nn] = pend[key];
            end[nn] = sec;
            note[nn++] = key % NOTES;
            seq[key] = -1;
        }
    }
    /* the notes left pending, in the dict's insertion order */
    left = malloc(sizeof(int) * KEYS);
    if (!left) goto nomem;
    int nleft = 0;
    for (int k = 0; k < KEYS; k++)
        if (seq[k] >= 0) left[nleft++] = k;
    sort_seqs = seq;
    qsort(left, nleft, sizeof(int), seq_cmp);
    for (int j = 0; j < nleft; j++) {
        onset[nn] = pend[left[j]];
        end[nn] = pend[left[j]] + note_length;
        note[nn++] = left[j] % NOTES;
    }
    order = malloc(sizeof(Py_ssize_t) * (nn + 1));
    if (!order) goto nomem;
    for (Py_ssize_t k = 0; k < nn; k++) order[k] = k;
    sort_onsets = onset;
    qsort(order, nn, sizeof(Py_ssize_t), onset_cmp);

    /* note_groups' loop: the instrument round-robin a distinct onset,
     * groups in first-seen (inst, n) order */
    const Py_ssize_t slots = nbanks * NOTES;
    const double shift = (double)offset / 1000.0;
    gid = malloc(sizeof(int) * (nn + 1));
    gsec = malloc(sizeof(double) * (nn + 1));
    gcount = calloc(slots, sizeof(int));
    ofs = malloc(sizeof(Py_ssize_t) * (slots + 1));
    slot_gid = malloc(sizeof(int) * slots);
    gslot = malloc(sizeof(int) * (slots + 1));
    if (!gid || !gsec || !gcount || !ofs || !slot_gid || !gslot)
        goto nomem;
    for (Py_ssize_t k = 0; k < slots; k++) slot_gid[k] = -1;
    long long curri = -1;
    double lastsec = -1e9;
    for (Py_ssize_t k = 0; k < nn; k++) {
        Py_ssize_t j = order[k];
        long long nv = note[j] + dnote;
        double sec = onset[j] + shift;
        gid[k] = -1;
        if (sec != lastsec) {
            curri += 1;
            lastsec = sec;
        }
        if (nv < min_note || nv > max_note) continue;
        curri = ((curri % nbanks) + nbanks) % nbanks;
        int slot = (int)curri * NOTES + note[j];
        if (slot_gid[slot] < 0) {
            slot_gid[slot] = ng;
            gslot[ng++] = slot;
        }
        gid[k] = slot_gid[slot];
        gsec[k] = sec;
        gcount[gid[k]]++;
    }

    /* the Python objects */
    notes = PyList_New(nn);
    groups = PyDict_New();
    if (!notes || !groups) goto fail;
    for (Py_ssize_t k = 0; k < nn; k++) {
        Py_ssize_t j = order[k];
        PyObject *t = PyTuple_New(3);
        if (!t) goto fail;
        PyList_SET_ITEM(notes, k, t);
        PyObject *a = PyFloat_FromDouble(onset[j]);
        PyObject *b = PyFloat_FromDouble(end[j]);
        PyObject *c = PyLong_FromLong(note[j]);
        if (!a || !b || !c) {
            Py_XDECREF(a);
            Py_XDECREF(b);
            Py_XDECREF(c);
            goto fail;
        }
        PyTuple_SET_ITEM(t, 0, a);
        PyTuple_SET_ITEM(t, 1, b);
        PyTuple_SET_ITEM(t, 2, c);
    }
    lists = (PyObject **)PyMem_Calloc(ng + 1, sizeof(PyObject *));
    if (!lists) goto nomem;
    int ok = 1;
    for (int g = 0; g < ng && ok; g++) {
        int slot = gslot[g];
        PyObject *key = Py_BuildValue("(iL)", slot / NOTES,
                                      (long long)(slot % NOTES) + dnote);
        lists[g] = PyList_New(gcount[g]);
        ok = key && lists[g] && PyDict_SetItem(groups, key, lists[g]) == 0;
        Py_XDECREF(key);
        ofs[g] = 0;
    }
    for (Py_ssize_t k = 0; k < nn && ok; k++) {
        if (gid[k] < 0) continue;
        PyObject *f = PyFloat_FromDouble(gsec[k]);
        if (!f) {
            ok = 0;
            break;
        }
        PyList_SET_ITEM(lists[gid[k]], ofs[gid[k]]++, f);
    }
    if (!ok) goto fail;
    result = PyTuple_Pack(2, notes, groups);
    goto done;

nomem:
    PyErr_NoMemory();
    goto fail;
decline:
    result = Py_NewRef(Py_None);
    goto done;
fail:
    result = NULL;
done:
    if (lists) {
        for (int g = 0; g < ng; g++) Py_XDECREF(lists[g]);
        PyMem_Free(lists);
    }
    Py_XDECREF(notes);
    Py_XDECREF(groups);
    free(slot_gid);
    free(gslot);
    free(s.events);
    free(s.tempos);
    free(secs);
    free(onset);
    free(end);
    free(note);
    free(seq);
    free(left);
    free(order);
    free(gid);
    free(gsec);
    free(gcount);
    free(ofs);
    return result;
}

static PyMethodDef methods[] = {
    {"note_groups", (PyCFunction)(void (*)(void))note_groups, METH_FASTCALL,
     "note_groups(data, min_note, max_note, dnote, offset, note_length, "
     "banks) -> (notes, groups) or None where the core declines the song "
     "(see smf.c)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "smf",
    .m_doc = "The port's SMF core: one call a song (csrc/smf.c).",
    .m_size = -1,
    .m_methods = methods,
};

PyMODINIT_FUNC PyInit_smf(void) { return PyModule_Create(&module); }
