program golden_driver
!----------------------------------------------------------------------------
! Offline golden-data generator for the JAX radiation framework.
!
! Calls the reference kernels directly:
!   rrtmg_lw  (RRTMG/rrtmg_lw/gcm_model/src/rrtmg_lw_rad.F90:15)
!   rrtmg_sw  (RRTMG/rrtmg_sw/gcm_model/src/rrtmg_sw_rad.F90:68)
!   irrad     (GEOSirrad_GridComp/irrad.F90:27)
!   sorad     (GEOSsolar_GridComp/sorad.F90:43)
!
! Usage:   ./golden_driver golden_in_<scheme>.bin golden_out_<scheme>.bin
!
! The input file is a raw little-endian stream written by
! tools/golden_driver/make_golden.py export (schema documented there and
! in tests/golden/README.md): int32 header [scheme, ncol, nlay] followed
! by float32 arrays in Fortran (column-major) order.  The output file is
! the scheme's flux arrays, also column-major float32.  make_golden.py
! import converts the pair into tests/golden/*.npz for test_golden.py.
!
! Layout notes (make_golden.py performs all conversions):
!   * RRTMG arrays arrive SURFACE-FIRST (the reference convention,
!     rrtmg_lw_rad.F90:209), Chou arrays TOA-FIRST (sorad.F90:184-186).
!   * Pressures in hPa for all four kernels.
!----------------------------------------------------------------------------
   use rrtmg_lw_rad, only: rrtmg_lw
   use rrtmg_lw_init, only: rrtmg_lw_ini
   use rrtmg_sw_rad, only: rrtmg_sw
   use rrtmg_sw_init, only: rrtmg_sw_ini
   use cloud_condensate_inhomogeneity, only: set_inhomogeneity
   use irradmod, only: irrad
   use soradmod, only: sorad
   use sorad_constants, only: hk_uv_old, hk_ir_old
   use MAPL
   implicit none

   integer :: scheme, ncol, nlay, iu, ou, n
   character(len=1024) :: fin, fout
   type(MAPL_MetaComp), pointer :: meta => null()
   allocate (meta)

   call get_command_argument(1, fin)
   call get_command_argument(2, fout)
   open (newunit=iu, file=trim(fin), access='stream', &
         form='unformatted', status='old', convert='little_endian')
   open (newunit=ou, file=trim(fout), access='stream', &
         form='unformatted', status='replace', convert='little_endian')
   read (iu) scheme, ncol, nlay
   n = ncol
   select case (scheme)
   case (1); call run_rrtmg_lw()
   case (2); call run_rrtmg_sw()
   case (3); call run_chou_lw()
   case (4); call run_chou_sw()
   case default; stop 'unknown scheme id'
   end select
   close (iu); close (ou)

contains

   subroutine run_rrtmg_lw()
      real :: play(n, nlay), plev(n, 0:nlay), tlay(n, nlay)
      real :: tlev(n, 0:nlay), tsfc(n), emis(n, 16)
      real, dimension(n, nlay) :: h2ovmr, o3vmr, co2vmr, ch4vmr, &
         n2ovmr, o2vmr, cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr, &
         cldf, ciwp, clwp, rei, rel, zm
      real :: tauaer(n, nlay, 16), alat(n)
      integer :: dyofyr, cloudLM, cloudMH, iceflglw, liqflglw, inhm
      integer :: clearCounts(n, 4)
      real, dimension(n, nlay + 1) :: uflx, dflx, uflxc, dflxc, &
         duflx_dTs, duflxc_dTs
      real :: olrb(16, n), dolrb_dTs(16, n)
      logical :: band_output(16)

      read (iu) play, plev, tlay, tlev, tsfc, emis, h2ovmr, o3vmr, &
         co2vmr, ch4vmr, n2ovmr, o2vmr, cfc11vmr, cfc12vmr, cfc22vmr, &
         ccl4vmr, cldf, ciwp, clwp, rei, rel, tauaer, zm, alat
      read (iu) dyofyr, cloudLM, cloudMH, iceflglw, liqflglw, inhm

      call set_inhomogeneity(inhm)
      call rrtmg_lw_ini
      band_output = .true.
      call rrtmg_lw(n, nlay, n, .true., play, plev, tlay, tlev, tsfc, &
                    emis, h2ovmr, o3vmr, co2vmr, ch4vmr, n2ovmr, o2vmr, &
                    cfc11vmr, cfc12vmr, cfc22vmr, ccl4vmr, cldf, ciwp, &
                    clwp, rei, rel, iceflglw, liqflglw, tauaer, zm, &
                    alat, dyofyr, cloudLM, cloudMH, clearCounts, uflx, &
                    dflx, uflxc, dflxc, duflx_dTs, duflxc_dTs, &
                    band_output, olrb, dolrb_dTs)
      write (ou) uflx, dflx, uflxc, dflxc, duflx_dTs, duflxc_dTs, &
         olrb, dolrb_dTs
      write (ou) clearCounts
   end subroutine run_rrtmg_lw

   subroutine run_rrtmg_sw()
      real :: scon, adjes, coszen(n)
      real :: play(n, nlay), plev(n, nlay + 1), tlay(n, nlay)
      real, dimension(n, nlay) :: h2ovmr, o3vmr, co2vmr, ch4vmr, &
         o2vmr, cld, ciwp, clwp, rei, rel, zm
      real, dimension(n, nlay, 14) :: tauaer, ssaaer, asmaer
      real :: alat(n), asdir(n), asdif(n), aldir(n), aldif(n)
      integer :: isolvar, dyofyr, cloudLM, cloudMH, iceflgsw, &
                 liqflgsw, iaer, normFlx, inhm
      integer :: clearCounts(n, 4)
      real, dimension(n, nlay + 1) :: swuflx, swdflx, swuflxc, swdflxc
      real, dimension(n) :: nirr, nirf, parr, parf, uvrr, uvrf
      real :: fswband(n, 14)
      real, dimension(n) :: cotdtp, cotdhp, cotdmp, cotdlp, &
                            cotntp, cotnhp, cotnmp, cotnlp
      real, pointer :: drband(:, :), dfband(:, :)

      read (iu) scon, adjes, coszen, play, plev, tlay, h2ovmr, o3vmr, &
         co2vmr, ch4vmr, o2vmr, cld, ciwp, clwp, rei, rel, zm, alat, &
         tauaer, ssaaer, asmaer, asdir, asdif, aldir, aldif
      read (iu) isolvar, dyofyr, cloudLM, cloudMH, iceflgsw, liqflgsw, &
         iaer, normFlx, inhm

      call set_inhomogeneity(inhm)
      call rrtmg_sw_ini
      allocate (drband(n, 14), dfband(n, 14))
      call rrtmg_sw(meta, n, n, nlay, scon, adjes, coszen, isolvar, &
                    play, plev, tlay, h2ovmr, o3vmr, co2vmr, ch4vmr, &
                    o2vmr, iceflgsw, liqflgsw, cld, ciwp, clwp, rei, &
                    rel, dyofyr, zm, alat, iaer, tauaer, ssaaer, &
                    asmaer, asdir, asdif, aldir, aldif, cloudLM, &
                    cloudMH, normFlx, clearCounts, swuflx, swdflx, &
                    swuflxc, swdflxc, nirr, nirf, parr, parf, uvrr, &
                    uvrf, fswband, cotdtp, cotdhp, cotdmp, cotdlp, &
                    cotntp, cotnhp, cotnmp, cotnlp, .true., drband, &
                    dfband)
      write (ou) swuflx, swdflx, swuflxc, swdflxc, nirr, nirf, parr, &
         parf, uvrr, uvrf, fswband, drband, dfband
      write (ou) clearCounts
   end subroutine run_rrtmg_sw

   subroutine run_chou_lw()
      ! single surface type per column: fs=1, tg=ts, eg=emis
      ! (GEOS_IrradGridComp.F90 passes the tiled surface the same way)
      real :: ple(n, nlay + 1), ta(n, nlay), wa(n, nlay), oa(n, nlay)
      real :: tb(n), ts(n), emis(n, 10), co2
      real, dimension(n, nlay) :: n2o, ch4, cfc11, cfc12, cfc22, fcld
      real :: cwc(n, nlay, 4), reff(n, nlay, 4)
      real :: taua(n, nlay, 10), ssaa(n, nlay, 10), asya(n, nlay, 10)
      integer :: ict, icb, itrace
      real :: fs(n, 1), tg(n, 1), eg(n, 1, 10)
      real :: tv(n, 1), ev(n, 1, 10), rv(n, 1, 10)
      real, dimension(n, nlay + 1) :: flxu, flcu, flau, flxau, &
                                      flxd, flcd, flad, flxad, dfdts
      real :: sfcem(n), taudiag(n, nlay, 10)

      read (iu) ple, ta, wa, oa, tb, ts, emis, co2, n2o, ch4, cfc11, &
         cfc12, cfc22, cwc, fcld, reff, taua, ssaa, asya
      read (iu) ict, icb, itrace

      fs = 1.0; tg(:, 1) = ts; eg(:, 1, :) = emis
      tv = 0.0; ev = 0.0; rv = 0.0
      call irrad(n, nlay, ple, ta, wa, oa, tb, co2, itrace /= 0, n2o, &
                 ch4, cfc11, cfc12, cfc22, cwc, fcld, ict, icb, reff, &
                 1, fs, tg, eg, tv, ev, rv, 10, 10, taua, ssaa, asya, &
                 flxu, flcu, flau, flxau, flxd, flcd, flad, flxad, &
                 dfdts, sfcem, taudiag)
      write (ou) flxu, flcu, flau, flxau, flxd, flcd, flad, flxad, &
         dfdts, sfcem
   end subroutine run_chou_lw

   subroutine run_chou_sw()
      real :: cosz(n), pl(n, nlay + 1), ta(n, nlay), wa(n, nlay)
      real :: oa(n, nlay), co2
      real :: cwc(n, nlay, 4), fcld(n, nlay), reff(n, nlay, 4)
      real :: taua(n, nlay, 8), ssaa(n, nlay, 8), asya(n, nlay, 8)
      real, dimension(n) :: rsuvbm, rsuvdf, rsirbm, rsirdf
      integer :: ict, icb
      real, dimension(n, nlay + 1) :: flx, flc, flxu, flcu
      real, dimension(n) :: fdiruv, fdifuv, fdirpar, fdifpar, &
                            fdirir, fdifir
      real :: flx_sfc_band(n, 8)
      real, pointer :: drband(:, :), dfband(:, :)

      read (iu) cosz, pl, ta, wa, oa, co2, cwc, fcld, reff, taua, &
         ssaa, asya, rsuvbm, rsuvdf, rsirbm, rsirdf
      read (iu) ict, icb

      allocate (drband(n, 8), dfband(n, 8))
      call sorad(n, nlay, 8, cosz, pl, ta, wa, oa, co2, cwc, fcld, &
                 ict, icb, reff, hk_uv_old, hk_ir_old, taua, ssaa, &
                 asya, rsuvbm, rsuvdf, rsirbm, rsirdf, flx, flc, &
                 fdiruv, fdifuv, fdirpar, fdifpar, fdirir, fdifir, &
                 flxu, flcu, flx_sfc_band, .true., drband, dfband)
      write (ou) flx, flc, flxu, flcu, fdiruv, fdifuv, fdirpar, &
         fdifpar, fdirir, fdifir, flx_sfc_band, drband, dfband
   end subroutine run_chou_sw

end program golden_driver
