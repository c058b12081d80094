"""Decoded picture buffer: POC, reference lists, marking, output order.

Reference parity: JM-lineage `mbuffer.c` (SURVEY.md §2/§3.3; implemented from
spec 8.2.1, 8.2.4, 8.2.5, Annex C bumping).

Host-side control logic.  Pixel storage is owned by the caller: each stored
picture carries an opaque `planes` payload (numpy planes for the oracle,
device DPB slot handles for the TPU pipeline).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream.params import SPS
from .bitstream.slicehdr import SliceHeader

# MaxDpbMbs per level (spec Table A-1)
_MAX_DPB_MBS = {
    9: 396, 10: 396, 11: 900, 12: 2376, 13: 2376, 20: 2376, 21: 4752,
    22: 8100, 30: 8100, 31: 18000, 32: 20480, 40: 32768, 41: 32768,
    42: 34816, 50: 110400, 51: 184320, 52: 184320,
}


@dataclass
class DPBPicture:
    uid: int                  # unique picture id (for deblock bS identity)
    frame_num: int
    poc: int
    planes: object            # caller-owned payload
    is_ref: bool = True
    long_term: bool = False
    lt_idx: int = -1
    frame_num_wrap: int = 0
    output_needed: bool = True
    non_existing: bool = False  # generated by fill_frame_num_gaps (8.2.5.2)
    slot: int = -1            # device DPB slot (assigned by caller)
    # PAFF fields (spec 3.30/8.2): 0 = frame picture, 1 = top field,
    # 2 = bottom field; `pair` links the complementary field.
    parity: int = 0
    pair: "DPBPicture | None" = None
    # colocated motion for B direct modes (spec 8.4.1.2.1), per 4x4 block:
    col_mv: object = None       # [H4, W4, 2] int32
    col_refidx: object = None   # [H4, W4] int8 (raw index in col pic's list)
    col_ref_uid: object = None  # [H4, W4] int32 (picture identity, -1 intra)


class WovenPair:
    """Output payload for a complementary field pair: the emitter weaves
    top/bottom field rows into one progressive output frame."""

    __slots__ = ("top", "bottom")

    def __init__(self, top, bottom):
        self.top, self.bottom = top, bottom


class DPB:
    def __init__(self, sps: SPS):
        self.sps = sps
        frame_mbs = sps.pic_width_in_mbs * sps.pic_height_in_map_units
        max_dpb_mbs = _MAX_DPB_MBS.get(sps.level_idc, 184320)
        self.max_dpb_frames = max(1, min(max_dpb_mbs // max(1, frame_mbs), 16))
        self.max_dpb_frames = max(self.max_dpb_frames, sps.max_num_ref_frames)
        self.pics: list[DPBPicture] = []
        self._uid = 0
        # POC state (8.2.1)
        self.prev_poc_msb = 0
        self.prev_poc_lsb = 0
        self.prev_frame_num = 0
        self.prev_frame_num_offset = 0
        self.prev_ref_frame_num = 0
        self.mmco5_seen = False

    # ---- POC (spec 8.2.1) -------------------------------------------------

    def compute_poc(self, hdr: SliceHeader) -> int:
        """PicOrderCnt of the coded picture (spec 8.2.1).

        Frame pictures return PicOrderCnt(frame) = Min(TopFieldOrderCnt,
        BottomFieldOrderCnt); coded fields (hdr.field_pic_flag) return
        their own field order count."""
        sps = self.sps
        fpf = getattr(hdr, "field_pic_flag", 0)
        parity = getattr(hdr, "parity", 0)
        if hdr.is_idr:
            self.prev_poc_msb = 0
            self.prev_poc_lsb = 0
        if sps.pic_order_cnt_type == 0:
            max_lsb = sps.max_poc_lsb
            lsb = hdr.pic_order_cnt_lsb
            if lsb < self.prev_poc_lsb and \
                    (self.prev_poc_lsb - lsb) >= max_lsb // 2:
                msb = self.prev_poc_msb + max_lsb
            elif lsb > self.prev_poc_lsb and \
                    (lsb - self.prev_poc_lsb) > max_lsb // 2:
                msb = self.prev_poc_msb - max_lsb
            else:
                msb = self.prev_poc_msb
            poc = msb + lsb
            if hdr.nal_ref_idc:
                self.prev_poc_msb = msb
                self.prev_poc_lsb = lsb
            if not fpf:
                # TopFieldOrderCnt = poc; Bottom = Top + delta_bottom
                poc = min(poc, poc + hdr.delta_pic_order_cnt[0])
            return poc
        if sps.pic_order_cnt_type == 2:
            if hdr.is_idr:
                fno = 0
            elif self.prev_frame_num > hdr.frame_num:
                fno = self.prev_frame_num_offset + sps.max_frame_num
            else:
                fno = self.prev_frame_num_offset
            self.prev_frame_num_offset = fno
            self.prev_frame_num = hdr.frame_num
            tmp = 2 * (fno + hdr.frame_num)
            return tmp if hdr.nal_ref_idc else tmp - 1
        if sps.pic_order_cnt_type == 1:
            if hdr.is_idr:
                fno = 0
            elif self.prev_frame_num > hdr.frame_num:
                fno = self.prev_frame_num_offset + sps.max_frame_num
            else:
                fno = self.prev_frame_num_offset
            self.prev_frame_num_offset = fno
            self.prev_frame_num = hdr.frame_num
            n_ref = len(sps.offset_for_ref_frame)
            abs_frame_num = fno + hdr.frame_num
            if hdr.nal_ref_idc == 0 and abs_frame_num > 0:
                abs_frame_num -= 1
            expected = 0
            if abs_frame_num > 0 and n_ref:
                cycle = (abs_frame_num - 1) // n_ref
                in_cycle = (abs_frame_num - 1) % n_ref
                sum_cycle = sum(sps.offset_for_ref_frame)
                expected = cycle * sum_cycle + \
                    sum(sps.offset_for_ref_frame[:in_cycle + 1])
            if hdr.nal_ref_idc == 0:
                expected += sps.offset_for_non_ref_pic
            if parity == 0:
                top = expected + hdr.delta_pic_order_cnt[0]
                bot = top + sps.offset_for_top_to_bottom_field + \
                    hdr.delta_pic_order_cnt[1]
                return min(top, bot)
            if parity == 2:              # coded bottom field
                return expected + sps.offset_for_top_to_bottom_field + \
                    hdr.delta_pic_order_cnt[0]
            return expected + hdr.delta_pic_order_cnt[0]
        raise NotImplementedError(f"poc type {self.sps.pic_order_cnt_type}")

    # ---- gaps in frame_num (spec 8.2.5.2; JM fill_frame_num_gap) ----------

    def fill_frame_num_gaps(self, hdr: SliceHeader):
        """Generate "non-existing" short-term reference frames for skipped
        frame_num values.  Call before compute_poc for the new picture.
        Returns (generated_pics, bumped_outputs): the generated pictures
        (planes=None, never output) so the caller may bind placeholder
        pixel storage, plus any real output-pending pictures the gap
        insertion bumped out of the DPB (the caller must emit them)."""
        sps = self.sps
        if hdr.is_idr or not sps.gaps_in_frame_num_value_allowed_flag:
            return [], []
        mfn = sps.max_frame_num
        expected = (self.prev_ref_frame_num + 1) % mfn
        # 8.2.5.2: gap-generated non-existing pictures are FRAMES; when
        # the stream is field-coded, each one enters the DPB as a
        # complementary non-existing FIELD PAIR (one frame unit), so the
        # 8.2.4.2.5 field list derivation and field PicNum arithmetic
        # see it exactly like any other reference frame unit (JM
        # fill_frame_num_gap + dpb_split_field).
        fld = bool(getattr(hdr, "field_pic_flag", 0))
        gen: list[DPBPicture] = []
        bumped: list = []
        guard = 0
        while hdr.frame_num != expected and \
                hdr.frame_num != self.prev_ref_frame_num and guard < mfn:
            guard += 1

            class _GapHdr:
                is_idr = False
                nal_ref_idc = 1
                frame_num = expected
                pic_order_cnt_lsb = 0
                delta_pic_order_cnt = (0, 0)

            # POC for non-existing frames is only derived for
            # pic_order_cnt_type != 0 (spec 8.2.5.2; JM fill_frame_num_gap):
            # running the type-0 derivation would corrupt
            # prev_poc_msb/prev_poc_lsb for the following real pictures.
            poc = 0
            if sps.pic_order_cnt_type != 0:
                poc = self.compute_poc(_GapHdr())
            self._update_frame_num_wrap(expected)
            if fld:
                self._sliding_window_field()
                top = DPBPicture(uid=self._uid, frame_num=expected,
                                 poc=poc, planes=None, is_ref=True,
                                 output_needed=False, non_existing=True,
                                 parity=1)
                bot = DPBPicture(uid=self._uid + 1, frame_num=expected,
                                 poc=poc, planes=None, is_ref=True,
                                 output_needed=False, non_existing=True,
                                 parity=2)
                self._uid += 2
                top.pair = bot
                bot.pair = top
                self.pics.extend((top, bot))
                gen.extend((top, bot))
            else:
                self._sliding_window()
                pic = DPBPicture(uid=self._uid, frame_num=expected,
                                 poc=poc, planes=None, is_ref=True,
                                 output_needed=False, non_existing=True)
                self._uid += 1
                self.pics.append(pic)
                gen.append(pic)
            self._update_frame_num_wrap(expected)
            while len(self._units()) > self.max_dpb_frames:
                n0 = len(self.pics)
                planes = self._bump_one()
                if planes is not None:
                    bumped.append(planes)
                elif len(self.pics) == n0:
                    break
            self.prev_ref_frame_num = expected
            expected = (expected + 1) % mfn
        return gen, bumped

    # ---- PAFF frame units (spec 8.2.4.2.5 / 8.2.5.3) -----------------------

    def _units(self):
        """DPB pictures grouped into frame units, in decoding order: a
        complementary field pair is one (top, bottom) unit; a frame or a
        (still-)unpaired field is a unit of its own."""
        units, seen = [], set()
        for p in self.pics:
            if id(p) in seen:
                continue
            seen.add(id(p))
            if p.pair is not None:
                seen.add(id(p.pair))
                units.append((p, p.pair) if p.parity == 1 else (p.pair, p))
            else:
                units.append((p,))
        return units

    @staticmethod
    def _alternate(frames, parity: int, pred):
        """Spec 8.2.4.2.5: frame list -> field list.  Fields satisfying
        `pred` are taken in frame-list order per parity; the output
        alternates parities starting with the current field's, and when
        one parity runs dry the remaining fields of the other parity
        follow in order."""
        seq = {1: [], 2: []}
        for u in frames:
            for p in u:
                if p.parity and pred(p):
                    seq[p.parity].append(p)
        out, want, i = [], parity, {1: 0, 2: 0}
        while i[1] < len(seq[1]) or i[2] < len(seq[2]):
            if i[want] < len(seq[want]):
                out.append(seq[want][i[want]])
                i[want] += 1
            want = 3 - want
        return out

    def _field_pic_num(self, p: DPBPicture, cur_parity: int) -> int:
        """PicNum of a short-term reference field (spec 8.2.4.1):
        2 * FrameNumWrap + 1 when same parity as the current field."""
        return 2 * p.frame_num_wrap + (1 if p.parity == cur_parity else 0)

    def _field_lt_pic_num(self, p: DPBPicture, cur_parity: int) -> int:
        """LongTermPicNum of a long-term reference field."""
        return 2 * p.lt_idx + (1 if p.parity == cur_parity else 0)

    def _init_list_p_field(self, hdr: SliceHeader):
        """P-field reference list (spec 8.2.4.2.2 + 8.2.4.2.5)."""
        self._update_frame_num_wrap(hdr.frame_num)
        par = hdr.parity
        st_units = [u for u in self._units()
                    if any(p.is_ref and not p.long_term for p in u)]
        st_units.sort(key=lambda u: -max(p.frame_num_wrap for p in u
                                         if p.is_ref and not p.long_term))
        lt_units = [u for u in self._units()
                    if any(p.is_ref and p.long_term for p in u)]
        lt_units.sort(key=lambda u: min(p.lt_idx for p in u
                                        if p.is_ref and p.long_term))
        lst = self._alternate(st_units, par,
                              lambda p: p.is_ref and not p.long_term)
        lst += self._alternate(lt_units, par,
                               lambda p: p.is_ref and p.long_term)
        return self._reorder_field(lst, hdr.ref_pic_list_mods_l0, hdr,
                                   hdr.num_ref_idx_l0_active)

    def _init_lists_b_field(self, hdr: SliceHeader, cur_poc: int):
        """B-field reference lists (spec 8.2.4.2.4 + 8.2.4.2.5)."""
        self._update_frame_num_wrap(hdr.frame_num)
        par = hdr.parity

        def unit_poc(u):
            # PicOrderCnt of the frame unit over its reference fields
            # (spec 8.2.4.1: Min over fields; only marked fields exist
            # for ordering purposes when decoding a field)
            e = [p.poc for p in u if p.is_ref and not p.long_term]
            return min(e)

        st_units = [u for u in self._units()
                    if any(p.is_ref and not p.long_term for p in u)]
        before = sorted((u for u in st_units if unit_poc(u) <= cur_poc),
                        key=lambda u: -unit_poc(u))
        after = sorted((u for u in st_units if unit_poc(u) > cur_poc),
                       key=unit_poc)
        lt_units = [u for u in self._units()
                    if any(p.is_ref and p.long_term for p in u)]
        lt_units.sort(key=lambda u: min(p.lt_idx for p in u
                                        if p.is_ref and p.long_term))
        st_pred = lambda p: p.is_ref and not p.long_term
        lt_pred = lambda p: p.is_ref and p.long_term
        l0 = self._alternate(before + after, par, st_pred) + \
            self._alternate(lt_units, par, lt_pred)
        l1 = self._alternate(after + before, par, st_pred) + \
            self._alternate(lt_units, par, lt_pred)
        if len(l0) > 1 and len(l1) > 1 and l0 == l1:
            l1 = [l1[1], l1[0]] + l1[2:]
        f0 = self._reorder_field(l0, hdr.ref_pic_list_mods_l0, hdr,
                                 hdr.num_ref_idx_l0_active)
        f1 = self._reorder_field(l1, hdr.ref_pic_list_mods_l1, hdr,
                                 hdr.num_ref_idx_l1_active)
        f0 = f0 + [p for p in l0 if p not in f0]
        f1 = f1 + [p for p in l1 if p not in f1]
        return f0, f1

    def _reorder_field(self, lst, mods, hdr: SliceHeader, num_active: int):
        """Spec 8.2.4.3 in FIELD pic-num arithmetic: CurrPicNum =
        2 * frame_num + 1, MaxPicNum = 2 * MaxFrameNum; short-term targets
        matched by field PicNum, long-term by field LongTermPicNum."""
        lst = list(lst)
        if not mods:
            return lst[:num_active]
        par = hdr.parity
        max_pn = 2 * self.sps.max_frame_num
        lst = lst + [None] * max(0, num_active - len(lst))
        pred = 2 * hdr.frame_num + 1
        idx = 0
        for m in mods:
            if m.idc in (0, 1):
                diff = m.value + 1
                pred = (pred - diff) % max_pn if m.idc == 0 else \
                    (pred + diff) % max_pn
                pic = next(
                    (p for p in self._short_refs() if p.parity and
                     self._field_pic_num(p, par) % max_pn == pred), None)
            else:
                pic = next(
                    (p for p in self._long_refs() if p.parity and
                     self._field_lt_pic_num(p, par) == m.value), None)
            if pic is None:
                raise ValueError("field reorder target not in DPB")
            lst = lst[:idx] + [pic] + [p for p in lst[idx:] if p is not pic]
            idx += 1
        return lst[:num_active]

    # ---- reference lists (spec 8.2.4) -------------------------------------

    def _short_refs(self):
        return [p for p in self.pics if p.is_ref and not p.long_term]

    def _long_refs(self):
        return sorted((p for p in self.pics if p.is_ref and p.long_term),
                      key=lambda p: p.lt_idx)

    def _update_frame_num_wrap(self, cur_frame_num: int) -> None:
        mfn = self.sps.max_frame_num
        for p in self._short_refs():
            p.frame_num_wrap = p.frame_num - mfn \
                if p.frame_num > cur_frame_num else p.frame_num

    def init_list_p(self, hdr: SliceHeader) -> list[DPBPicture]:
        if getattr(hdr, "field_pic_flag", 0):
            return self._init_list_p_field(hdr)
        self._update_frame_num_wrap(hdr.frame_num)
        lst = sorted(self._short_refs(), key=lambda p: -p.frame_num_wrap)
        lst += self._long_refs()
        return self._reorder(lst, hdr.ref_pic_list_mods_l0, hdr,
                             hdr.num_ref_idx_l0_active)

    def init_lists_b(self, hdr: SliceHeader, cur_poc: int):
        if getattr(hdr, "field_pic_flag", 0):
            return self._init_lists_b_field(hdr, cur_poc)
        self._update_frame_num_wrap(hdr.frame_num)
        st = self._short_refs()
        before = sorted((p for p in st if p.poc <= cur_poc), key=lambda p: -p.poc)
        after = sorted((p for p in st if p.poc > cur_poc), key=lambda p: p.poc)
        lt = self._long_refs()
        l0 = before + after + lt
        l1 = after + before + lt
        if len(l0) > 1 and len(l1) > 1 and l0 == l1:
            l1 = [l1[1], l1[0]] + l1[2:]
        # Temporal direct may produce refIdxL0 > num_ref_idx_l0_active-1
        # (spec 8.4.1.2.3 note): keep the initial-order tail past num_active.
        f0 = self._reorder(l0, hdr.ref_pic_list_mods_l0, hdr,
                           hdr.num_ref_idx_l0_active)
        f1 = self._reorder(l1, hdr.ref_pic_list_mods_l1, hdr,
                           hdr.num_ref_idx_l1_active)
        f0 = f0 + [p for p in l0 if p not in f0]
        f1 = f1 + [p for p in l1 if p not in f1]
        return f0, f1

    def _reorder(self, lst, mods, hdr: SliceHeader, num_active: int):
        lst = list(lst)[:]
        # pad conceptually: reordering operates on a list of size num_active
        if not mods:
            return lst[:num_active]
        max_fn = self.sps.max_frame_num
        # spec 8.2.4.3: build with insertion semantics
        lst = lst + [None] * max(0, num_active - len(lst))
        lst = lst[:max(num_active, len(lst))]
        pred = hdr.frame_num
        idx = 0
        for m in mods:
            if m.idc in (0, 1):
                diff = m.value + 1
                pred = (pred - diff) % max_fn if m.idc == 0 else \
                    (pred + diff) % max_fn
                pic = next((p for p in self._short_refs()
                            if (p.frame_num % max_fn) == pred), None)
            else:
                pic = next((p for p in self._long_refs()
                            if p.lt_idx == m.value), None)
            if pic is None:
                raise ValueError("reorder target not in DPB")
            # move pic to position idx, shifting others right
            lst = [p for p in lst[:idx] if True] + [pic] + \
                [p for p in lst[idx:] if p is not pic]
            idx += 1
        return lst[:num_active]

    # ---- store + marking (spec 8.2.5) + bumping (Annex C) -----------------

    def store(self, planes, hdr: SliceHeader, poc: int):
        """Store the decoded picture.

        Returns (outputs, pic): output payloads ready for emission in order,
        and the stored DPBPicture (so the caller can assign a device slot).
        """
        out = []
        if hdr.is_idr:
            if hdr.no_output_of_prior_pics_flag:
                self.pics.clear()
            else:
                out.extend(self._bump_all(flush=True))
            self.pics.clear()
        pic = DPBPicture(uid=self._uid, frame_num=hdr.frame_num, poc=poc,
                         planes=planes, is_ref=bool(hdr.nal_ref_idc),
                         parity=getattr(hdr, "parity", 0))
        self._uid += 1
        # PAFF pairing (spec 3.30): the immediately preceding picture in
        # decoding order, when it is an unpaired opposite-parity field
        # with the same frame_num, forms a complementary field pair with
        # this one (ref or not — pairing drives woven output; marking
        # below stays per FIELD).
        sibling = None
        if pic.parity and self.pics:
            cand = self.pics[-1]
            if cand.parity == 3 - pic.parity and cand.pair is None \
                    and cand.frame_num == hdr.frame_num:
                sibling = cand
        if pic.is_ref:
            self.prev_ref_frame_num = hdr.frame_num
        if hdr.is_idr and hdr.long_term_reference_flag:
            pic.long_term = True
            pic.lt_idx = 0
        if pic.is_ref and not hdr.is_idr:
            if hdr.adaptive_ref_pic_marking_mode_flag:
                self._apply_mmco(hdr, pic)
            elif pic.parity and sibling is not None and sibling.is_ref \
                    and not sibling.long_term:
                pass  # 8.2.5.3: second field of a complementary reference
                      # field pair invokes no sliding-window marking
            elif pic.parity:
                self._sliding_window_field()
            else:
                self._sliding_window()
        if sibling is not None:
            pic.pair = sibling
            sibling.pair = pic
        self.pics.append(pic)
        # bumping: emit smallest-POC frame unit while over capacity
        while len(self._units()) > self.max_dpb_frames:
            n0 = len(self.pics)
            got = self._bump_one()
            out.append(got)
            if got is None and len(self.pics) == n0:
                break   # nothing emittable or droppable right now
        return [o for o in out if o is not None], pic

    def _sliding_window(self) -> None:
        num_ref = sum(1 for p in self.pics if p.is_ref)
        if num_ref >= max(1, self.sps.max_num_ref_frames):
            st = self._short_refs()
            if st:
                oldest = min(st, key=lambda p: p.frame_num_wrap)
                oldest.is_ref = False
                self._gc()

    def _sliding_window_field(self) -> None:
        """Spec 8.2.5.3 in FRAME-unit counts: max_num_ref_frames bounds
        reference frames / complementary reference field pairs / unpaired
        reference fields; the oldest short-term unit has BOTH fields
        unmarked."""
        units = [u for u in self._units() if any(p.is_ref for p in u)]
        if len(units) >= max(1, self.sps.max_num_ref_frames):
            st = [u for u in units
                  if any(p.is_ref and not p.long_term for p in u)]
            if st:
                oldest = min(
                    st, key=lambda u: min(p.frame_num_wrap for p in u
                                          if p.is_ref and not p.long_term))
                for p in oldest:
                    p.is_ref = False
                self._gc()

    def _apply_mmco(self, hdr: SliceHeader, cur: DPBPicture) -> None:
        # PicNumX (spec 8.2.5.4.1) compares against each short-term
        # picture's PicNum = FrameNumWrap, which is relative to the
        # CURRENT frame_num.  P/B slices refreshed it in init_list_*,
        # but an I slice with MMCO (legal) would otherwise use wraps
        # stale from the previous picture.
        self._update_frame_num_wrap(hdr.frame_num)
        max_fn = self.sps.max_frame_num
        # Field pictures run the ops in FIELD pic-num arithmetic
        # (spec 8.2.5.4: CurrPicNum = 2 * frame_num + 1, and ops 1-3
        # mark/assign INDIVIDUAL fields).
        fld = bool(getattr(hdr, "field_pic_flag", 0))
        par = getattr(hdr, "parity", 0)
        cur_pn = 2 * hdr.frame_num + 1 if fld else hdr.frame_num
        max_pn = 2 * max_fn if fld else max_fn
        pn = (lambda p: self._field_pic_num(p, par)) if fld \
            else (lambda p: p.frame_num_wrap)
        lt_pn = (lambda p: self._field_lt_pic_num(p, par)) if fld \
            else (lambda p: p.lt_idx)
        for m in hdr.mmcos:
            if m.op == 1:
                pic_num = cur_pn - (m.val1 + 1)
                for p in self._short_refs():
                    if (pn(p) % max_pn + max_pn) % max_pn == \
                            (pic_num % max_pn + max_pn) % max_pn or \
                            pn(p) == pic_num:
                        p.is_ref = False
            elif m.op == 2:
                for p in self._long_refs():
                    if lt_pn(p) == m.val1:
                        p.is_ref = False
            elif m.op == 3:
                pic_num = cur_pn - (m.val1 + 1)
                for p in self._short_refs():
                    if pn(p) == pic_num:
                        p.long_term = True
                        p.lt_idx = m.val2
            elif m.op == 4:
                keep = m.val1 - 1
                for p in self._long_refs():
                    if p.lt_idx > keep:
                        p.is_ref = False
            elif m.op == 5:
                for p in self.pics:
                    p.is_ref = False
                self.mmco5_seen = True
            elif m.op == 6:
                cur.long_term = True
                cur.lt_idx = m.val1
        self._gc()

    def _gc(self) -> None:
        self.pics = [p for p in self.pics if p.is_ref or p.output_needed]

    def _bump_one(self, flush: bool = False):
        """Emit the smallest-POC output-pending FRAME UNIT.  A complete
        field pair emits a WovenPair payload; an unpaired field is only
        emittable at flush time (its complement may still arrive) — it
        then self-weaves (line-doubled), the JM-class unpaired-field
        output convention."""
        cand = [u for u in self._units()
                if all(p.output_needed for p in u)
                and (u[0].parity == 0 or len(u) == 2 or flush)]
        if not cand:
            # drop non-ref pictures to make room (never an unpaired
            # field still awaiting its complement)
            self.pics = [p for p in self.pics
                         if p.is_ref or (p.parity and p.pair is None)]
            return None
        unit = min(cand, key=lambda u: min(p.poc for p in u))
        for p in unit:
            p.output_needed = False
        self._gc()
        if unit[0].parity == 0:
            return unit[0].planes
        if len(unit) == 2:
            return WovenPair(unit[0].planes, unit[1].planes)
        p = unit[0]
        return WovenPair(p.planes, p.planes)

    def _bump_all(self, flush: bool = False):
        out = []
        while any(p.output_needed for p in self.pics):
            got = self._bump_one(flush=flush)
            out.append(got)
            if got is None and not any(
                    p.output_needed and
                    (p.parity == 0 or p.pair is not None or flush)
                    for p in self.pics):
                break   # only unpaired fields remain; wait for complements
        return [o for o in out if o is not None]

    def flush(self):
        out = self._bump_all(flush=True)
        self.pics.clear()
        return out
