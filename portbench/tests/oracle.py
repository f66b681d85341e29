"""Integer models of the MAC circuits: a frozen copy of the generator's
oracles (the functions `expected` and `memmac_expected` of the script that
wrote the circuits), which the reference evaluator is held to."""

MEMMAC = {"rom_addr": 7, "rom_width": 32, "ram_addr": 8, "ram_width": 8}


def mac_expected(W: int, a_vals, b_vals, cycles: int) -> int:
    """@acc of MAC-W after `cycles` cycles fed the circular streams."""
    acc = 0
    for c in range(cycles):
        acc += a_vals[c % len(a_vals)] * b_vals[c % len(b_vals)]
    return acc % (1 << (2 * W))


def memmac_expected(rom, rams, streams, cycles: int):
    """memmac after `cycles` cycles (after the @reset settle):
    ({"acc", "rdataA", "rdataB"} of the last cycle, {ram: final bits})."""
    m = MEMMAC

    def word(bits, i, w):
        return sum(int(bits[i * w + k]) << k for k in range(w))

    def field(name, c, w):
        n = len(streams[name]) // w
        return word(streams[name], c % n, w)

    mem = {nm: [word(b, i, m["ram_width"])
                for i in range(1 << m["ram_addr"])]
           for nm, b in rams.items()}
    acc, out = 0, {}
    for c in range(cycles):
        rdata = word(rom, field("romaddr", c, m["rom_addr"]), m["rom_width"])
        acc = (acc + (rdata & 15) * ((rdata >> 4) & 15)) % 256
        out["acc"] = acc
        wdata_b = field("wdataB", c, m["ram_width"])
        for x, wdata in (("A", acc), ("B", wdata_b)):
            ram = mem[f"ram{x}"]
            addr = field(f"addr{x}", c, m["ram_addr"])
            out[f"rdata{x}"] = ram[addr]
            if field(f"wren{x}", c, 1):
                ram[addr] = wdata
    final = {nm: [(v >> k) & 1 for v in words for k in range(m["ram_width"])]
             for nm, words in mem.items()}
    return out, final
