"""The build report's parsers (`repro_torch.kernels.nvcc`): kernel names
from mangled symbols, and the spill and wgmma-serialisation verdicts that
`chip_smoke.py`'s setup fails on. Pure text processing: runs on the CPU."""
import pytest

from repro_torch.kernels import nvcc


@pytest.mark.parametrize("symbol,name", [
    # nvcc's anonymous namespace carries a hash of the file
    ("_ZN44_GLOBAL__N__34864b56_11_bfc_step_cu_e601367615bfc_step_kernel"
     "ILb0ELb1EEEvPKiPKhS2_S4_S2_iiiiPiS5_PhS5_S6_S5_",
     "bfc_step_kernel<0, 1>"),
    ("_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi256EEEv14CUtensorMap_st",
     "flash_fwd_bf16_kernel<256>"),
    ("_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi96EEEvPKT_",
     "flash_fwd_kernel<float, 96>"),
    ("_ZN3foo3barEv", "bar"),
    ("_Z3fooPi", "_Z3fooPi"),                           # not nested
    ("_ZN3foo3barI13__nv_bfloat16EEvv",                  # a type argument
     "_ZN3foo3barI13__nv_bfloat16EEvv"),
])
def test_kernel_name_demangles_template_instances(symbol, name):
    assert nvcc.kernel_name(symbol) == name


ENTRY = ("ptxas info    : Compiling entry function "
         "'_ZN12_GLOBAL__N_121flash_fwd_bf16_kernelILi64EEEv14CUtensorMap_st'"
         " for 'sm_90a'\n")
CLEAN = ("ptxas info    : Function properties for x\n"
         "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
         "ptxas info    : Used 168 registers, used 1 barriers\n")


@pytest.mark.parametrize("extra,spilled,serialized", [
    ("", False, False),
    ("    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n",
     True, False),
    ("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
     "instructions are serialized\n", False, True),
])
def test_ptxas_report_flags_spills_and_serialised_wgmma(extra, spilled,
                                                        serialized):
    lines, got_spilled, got_serialized = nvcc.ptxas_report(
        ENTRY + CLEAN + extra)
    assert (got_spilled, got_serialized) == (spilled, serialized)
    assert all(x.startswith("flash_fwd_bf16_kernel<64>: ") for x in lines)
    assert any("Used 168 registers" in x for x in lines)
